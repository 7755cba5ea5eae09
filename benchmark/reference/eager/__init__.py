"""Frozen copies of the port's eager modules (gpnerf_tpu_torch at commit
ffa1347), the benchmark's plain reference; see benchmark/reference/build.py."""

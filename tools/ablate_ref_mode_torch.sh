#!/bin/bash
# Reference-mode quality ablation of the PyTorch/CUDA port: the flag ladder
# of tools/ablate_ref_mode.sh, from the fast defaults to the reference cull's
# semantics one flag at a time, each rung a full-test-set sweep through
# tools/quality_sweep_torch.py. The summary JSON line of each rung goes to
# artifacts/ablate_torch.jsonl (artifacts/ablate_r4.jsonl is the JAX
# package's record and is not written). Extra arguments (e.g. `device cpu`)
# are passed to every rung.
#   bash tools/ablate_ref_mode_torch.sh
set -u
OUT=artifacts/ablate_torch.jsonl
EXTRA=("$@")
: > "$OUT"
run() {
  name="$1"; shift
  echo "== $name: $*" >&2
  line=$(timeout 2400 python -u tools/quality_sweep_torch.py "$@" "${EXTRA[@]}" 2>/dev/null | tail -1)
  echo "{\"ablation\": \"$name\", \"result\": $line}" >> "$OUT"
  echo "$line" >&2
}
run fast_defaults
run lowres_src_off tpu.merge_lowres_src False
run k64_dropfree tpu.samples_per_ray 64 tpu.sigma_cap 2621440
run blanket_cull tpu.tight_cull False tpu.tap_window 0 tpu.splat_bins False \
    tpu.samples_per_ray 64 tpu.ray_cap 65536 tpu.sigma_cap 2621440 \
    tpu.rgb_cap 1048576
run full_ref_mode tpu.tight_cull False tpu.tap_window 0 tpu.splat_bins False \
    tpu.samples_per_ray 64 tpu.ray_cap 65536 tpu.sigma_cap 2621440 \
    tpu.rgb_cap 1048576 tpu.merge_lowres_src False

#!/usr/bin/env python3
"""Gather-strategy microbenchmark of the PyTorch/CUDA port
(gpnerf_tpu_torch/utils/bench_gather.py): prints one line per measurement
with the card's name and power limit.

    python3 tools/bench_gather_torch.py            # on the GPU
    python3 tools/bench_gather_torch.py --cpu -n 65536

Exits non-zero without a CUDA device unless --cpu is given; host-clock times
of a --cpu run say nothing about a card.
"""

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    import torch

    from gpnerf_tpu_torch.utils.bench_gather import run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    ap.add_argument("-n", "--n-queries", type=int, default=8 * 1024 * 1024)
    args = ap.parse_args()
    if args.cpu:
        device, where = "cpu", "cpu (host clock)"
    else:
        if not torch.cuda.is_available():
            print("no CUDA device: pass --cpu to run the plain versions", file=sys.stderr)
            return 2
        device = "cuda"
        where = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    res = run(device, n_queries=args.n_queries)
    for key, val in res.items():
        if key.endswith("_ms"):
            print(f"{key[:-3]:32s} {val:10.3f} ms   [{where}]")
        elif key.endswith("_gb_s"):
            print(f"{key[:-5]:32s} {val:10.1f} GB/s [{where}]")
        else:
            print(f"{key:32s} {val}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""gpnerf_tpu_torch — the PyTorch/CUDA port of gpnerf_tpu for NVIDIA Hopper.

The package mirrors gpnerf_tpu's layout (config/, data/, models/, ops/,
render/, train/) so each module's counterpart sits at the same path. Plain
tensor code is PyTorch; each TPU kernel of the JAX package becomes a
hand-written CUDA kernel under csrc/, built at first use into the
git-ignored _build/ directory. The package imports neither JAX nor
gpnerf_tpu: what it shares with the JAX package (config schema, synthetic
data pipeline, host sparse rulebooks) is its own copy.

Entry points run on the GPU (`device="cuda"`) unless the caller passes
`device="cpu"`, which the CPU tests do.
"""

__version__ = "0.1.0"

"""inferix_tpu_torch — the PyTorch/CUDA port of the semi-AR video engine.

It runs on one NVIDIA H100 (sm_90a). Plain tensor code is PyTorch; every
kernel the JAX package wrote in Pallas for the TPU is a kernel written by hand
for Hopper (`csrc/`, built by `nvcc` at first use, bound with `ctypes`).

The module layout mirrors `inferix_tpu/`, so each counterpart is easy to
find. This package imports neither `jax` nor anything of `inferix_tpu`.
Entry points take `device=` and default to "cuda"; they raise when no card is
present, and only an explicit `device="cpu"` runs on the CPU, where every
kernel wrapper takes its plain PyTorch version.
"""

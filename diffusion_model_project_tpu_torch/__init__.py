"""PyTorch/CUDA port of ``diffusion_model_project_tpu`` for NVIDIA Hopper.

The layout mirrors the JAX package module for module. Tensors are
channels-first inside; the predictor keeps the JAX package's channels-first
public contract (``img (B,S,1,H,W)``, ``velocity_2d (B,S,3,H,W)``).
GroupNorm(+activation) and multi-head self-attention on CUDA tensors run
through hand-written kernels (``csrc/``, bound in ``ops/cuda/``); on CPU
tensors they take the plain PyTorch versions in ``ops/``. The conv probe
(``scripts/perf_probe_conv.py``) drives a third kernel, the 3x3 conv of
``ops/cuda/conv3x3.py``, which the models do not call.

This package imports no ``jax`` and nothing of ``diffusion_model_project_tpu``.
"""

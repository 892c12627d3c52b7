"""K2: multi-head self-attention, hand-written CUDA kernels (``csrc/attention.cu``).

Replaces ``diffusion_model_project_tpu/ops/pallas/attention.py::fused_attention``.
One call launches three kernels: the QKV projection (GEMM + bias), the
attention core and the output projection (GEMM + bias). On a CUDA tensor
the wrapper launches them or raises; on a CPU tensor it takes the plain
version (``ops/attention.multihead_attention``).
"""
from __future__ import annotations

import torch

from ..attention import multihead_attention
from . import _lib

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the UNet's head dims (128, 256, 512) and a small one for the card tests
HEAD_DIMS = (32, 128, 256, 512)
MAX_TOKENS = 1024
_SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90

# wrapper calls that launched the kernels (not counting CPU calls)
LAUNCHES = 0


def _weight_strides(w: torch.Tensor, k: int, n: int):
    """(stride_k, stride_n) of a (K, N) weight that is row-major or a
    transposed view of a contiguous (N, K) matrix; raises otherwise."""
    if w.shape != (k, n):
        raise ValueError(f"fused_attention: weight shape {tuple(w.shape)} != {(k, n)}")
    if w.is_contiguous():
        return n, 1
    if w.t().is_contiguous():
        return 1, k
    raise ValueError("fused_attention: weights must be row-major or a transposed view")


def _gemm_bias(x2: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m, k = x2.shape
    n = w.shape[1]
    sk, sn = _weight_strides(w, k, n)
    if b.shape != (n,):
        raise ValueError(f"fused_attention: bias shape {tuple(b.shape)} != {(n,)}")
    bias = b.float().contiguous()
    y = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    err = _lib.lib().dm_gemm_bias(
        _DTYPE_CODES[x2.dtype], x2.data_ptr(), w.data_ptr(), sk, sn, bias.data_ptr(),
        y.data_ptr(), m, n, k, _lib.stream_ptr(x2))
    _lib.check(err, "fused_attention (gemm_bias)")
    return y


def fused_attention(x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: torch.Tensor,
                    w_out: torch.Tensor, b_out: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Self-attention on ``(N, T, E)``; ``w_qkv (E, 3E)``, ``w_out (E, E)`` (JAX layouts)."""
    if x.device.type == "cpu":
        return multihead_attention(x, w_qkv, b_qkv, w_out, b_out, num_heads)
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {x.device}")
    tensors = (x, w_qkv, b_qkv, w_out, b_out)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("fused_attention has no backward; call it without grad")
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_attention: all tensors must be on x's device")
    if x.dtype not in _DTYPE_CODES or w_qkv.dtype != x.dtype or w_out.dtype != x.dtype:
        raise TypeError("fused_attention: x and weights must share a float32 or bfloat16 dtype")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError("fused_attention: x must be a contiguous (N, T, E) tensor")
    n, t, e = x.shape
    if e % num_heads != 0:
        raise ValueError(f"embed dim {e} not divisible by {num_heads} heads")
    hd = e // num_heads
    if hd not in HEAD_DIMS:
        raise ValueError(f"fused_attention: head dim {hd} not in {HEAD_DIMS}")
    smem = 4 * ((16 + 32) * (hd + 1) + 16 * (t + 1))
    if t > MAX_TOKENS or smem > _SMEM_LIMIT or n > 65535:
        raise ValueError(f"fused_attention: (N, T, hd) = {(n, t, hd)} outside the kernel's range")
    qkv = _gemm_bias(x.view(n * t, e), w_qkv, b_qkv)
    core = torch.empty((n, t, e), dtype=x.dtype, device=x.device)
    err = _lib.lib().dm_attention_core(
        _DTYPE_CODES[x.dtype], qkv.data_ptr(), core.data_ptr(), n, t, num_heads, hd,
        _lib.stream_ptr(x))
    _lib.check(err, "fused_attention (core)")
    out = _gemm_bias(core.view(n * t, e), w_out, b_out)
    LAUNCHES += 1
    return out.view(n, t, e)

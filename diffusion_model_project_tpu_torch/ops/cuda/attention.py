"""K2: multi-head self-attention, hand-written CUDA kernels (``csrc/attention.cu``).

Replaces ``diffusion_model_project_tpu/ops/pallas/attention.py::fused_attention``.
One call launches three kernels: the QKV projection (GEMM + bias), the
attention core and the output projection (GEMM + bias). On a CUDA tensor
the wrapper launches them or raises; on a CPU tensor it takes the plain
version (``ops/attention.multihead_attention``).

In bf16 the kernels read their operands with TMA, so every tensor they read
must start on a 16-byte boundary with rows a multiple of 16 bytes; the
wrapper checks both and raises otherwise. :func:`plan` picks each launch's
tile, ring stages and shared memory; it is plain Python, so the CPU tests
hold it to the card's limits.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..attention import multihead_attention
from . import _lib
from ._sm90 import ALIGN_SLACK, SMEM_LIMIT, SMS, cdiv

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the UNet's head dims (128, 256, 512) and a small one for the card tests
HEAD_DIMS = (32, 128, 256, 512)
MAX_TOKENS = 1024
MAX_BATCH = 65535  # the core's grid.z
# GEMM tiles (rows, columns), largest first; the kernel has these instances
GEMM_TILES = ((128, 128), (128, 64), (64, 64))
GEMM_STAGES = 4
CORE_MAX_STAGES = 4

# wrapper calls that launched the kernels (not counting CPU calls), through the
# registered op too
LAUNCHES = 0


@dataclass(frozen=True)
class GemmPlan:
    bm: int
    bn: int
    stages: int
    smem: int   # dynamic shared memory bytes
    grid: tuple  # (row tiles, column tiles)


@dataclass(frozen=True)
class CorePlan:
    stages: int
    smem: int
    grid: tuple  # (64-query tiles, heads, samples)


class Plan(NamedTuple):
    qkv: GemmPlan
    core: CorePlan
    out: GemmPlan


def gemm_smem(bm: int, bn: int, stages: int) -> int:
    """Bytes of the GEMM's ring (A and B boxes of 64 K columns), its bf16
    epilogue tile (rows padded by 8) and its barriers (``csrc`` ``gemm_smem``)."""
    return ALIGN_SLACK + stages * (bm + bn) * 64 * 2 + bm * (bn + 8) * 2 + 16 * stages


def core_smem(hd: int, stages: int) -> int:
    """Bytes of the core's Q tile and ring of K/V tiles, 64 rows by
    max(hd, 64) columns each, and its barriers (``csrc`` ``core_smem``)."""
    return ALIGN_SLACK + 64 * max(hd, 64) * 2 * (1 + stages) + 8 * (2 * stages + 1)


def plan_gemm(m: int, n: int) -> GemmPlan:
    """The largest tile that still gives every SM a block, else the one with the most."""
    for bm, bn in GEMM_TILES:
        grid = (cdiv(m, bm), cdiv(n, bn))
        if grid[0] * grid[1] >= SMS:
            break
    return GemmPlan(bm, bn, GEMM_STAGES, gemm_smem(bm, bn, GEMM_STAGES), grid)


def plan_core(n: int, t: int, hd: int, heads: int) -> CorePlan:
    tile = 64 * max(hd, 64) * 2
    stages = min(CORE_MAX_STAGES, (SMEM_LIMIT - core_smem(hd, 0)) // (tile + 16))
    return CorePlan(stages, core_smem(hd, stages), (cdiv(t, 64), heads, n))


@functools.lru_cache(maxsize=64)
def plan(n: int, t: int, e: int, heads: int) -> Plan:
    """Launch plans of one call on (N, T, E) with ``heads`` heads: the QKV
    GEMM, the core and the output GEMM. Raises outside the kernels' range.
    Cached (the plans are immutable): a DDIM loop meets the same three
    shapes in every step."""
    if heads < 1 or e % heads != 0:
        raise ValueError(f"embed dim {e} not divisible by {heads} heads")
    hd = e // heads
    if hd not in HEAD_DIMS:
        raise ValueError(f"fused_attention: head dim {hd} not in {HEAD_DIMS}")
    if not (1 <= t <= MAX_TOKENS and 1 <= n <= MAX_BATCH):
        raise ValueError(f"fused_attention: (N, T, hd) = {(n, t, hd)} outside the kernel's range")
    return Plan(plan_gemm(n * t, 3 * e), plan_core(n, t, hd, heads), plan_gemm(n * t, e))


def _weight_strides(w: torch.Tensor, k: int, n: int):
    """(stride_k, stride_n) of a (K, N) weight that is row-major or a
    transposed view of a contiguous (N, K) matrix; raises otherwise."""
    if w.shape != (k, n):
        raise ValueError(f"fused_attention: weight shape {tuple(w.shape)} != {(k, n)}")
    strides = w.stride()
    if strides in ((n, 1), (1, k)):
        return strides
    raise ValueError("fused_attention: weights must be row-major or a transposed view")


def _check_tma(t: torch.Tensor, row_elems: int, what: str) -> None:
    if t.data_ptr() % 16 or (row_elems * t.element_size()) % 16:
        raise ValueError(f"fused_attention: {what} must start on a 16-byte boundary with rows "
                         f"a multiple of 16 bytes (TMA)")


def _gemm_bias(x: int, m: int, k: int, w: torch.Tensor, b: torch.Tensor, y: int,
               p: GemmPlan, dt: torch.dtype, stream: int) -> None:
    """y (M, N) = x (M, K) @ w + b, x and y contiguous buffers of ``dt`` given
    by their addresses."""
    n = w.shape[1]
    sk, sn = _weight_strides(w, k, n)
    if b.shape != (n,) or not b.is_contiguous():
        raise ValueError(f"fused_attention: bias must be a contiguous {(n,)} tensor")
    _check_tma(w, max(sk, sn), "the weights")
    err = _lib.lib().dm_gemm_bias(
        _DTYPE_CODES[dt], x, w.data_ptr(), sk, sn, b.data_ptr(), y, m, n, k, p.bm, p.bn,
        p.stages, p.smem, stream)
    _lib.check(err, "fused_attention (gemm_bias)")


def fused_attention(x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: torch.Tensor,
                    w_out: torch.Tensor, b_out: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Self-attention on ``(N, T, E)``; ``w_qkv (E, 3E)``, ``w_out (E, E)`` (JAX
    layouts), biases in x's dtype.

    Under ``torch.export`` the call is traced as the
    registered op ``torch.ops.dm_port.fused_attention``, whose body is this
    function; eager calls skip the op's dispatcher."""
    if torch.compiler.is_compiling():
        return torch.ops.dm_port.fused_attention(x, w_qkv, b_qkv, w_out, b_out, num_heads)
    if x.device.type == "cpu":
        return multihead_attention(x, w_qkv, b_qkv, w_out, b_out, num_heads)
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {x.device}")
    tensors = (x, w_qkv, b_qkv, w_out, b_out)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("fused_attention has no backward; call it without grad")
    dev, dt = x.device, x.dtype
    if any(t.device != dev for t in tensors):
        raise ValueError("fused_attention: all tensors must be on x's device")
    if dt not in _DTYPE_CODES or any(t.dtype != dt for t in tensors):
        raise TypeError("fused_attention: x, weights and biases must share a float32 or "
                        "bfloat16 dtype")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError("fused_attention: x must be a contiguous (N, T, E) tensor")
    n, t, e = x.shape
    p = plan(n, t, e, num_heads)
    _check_tma(x, e, "x")
    stream = _lib.stream_ptr(x)
    # qkv (N, T, 3E), then the core's output (N, T, E), in one scratch buffer;
    # the core's part starts 3 N T E elements in, 16-byte aligned as E is a
    # multiple of 32
    scratch = torch.empty(4 * x.numel(), dtype=dt, device=dev)
    qkv, core = scratch.data_ptr(), scratch.data_ptr() + 3 * x.numel() * x.element_size()
    out = torch.empty((n, t, e), dtype=dt, device=dev)
    _gemm_bias(x.data_ptr(), n * t, e, w_qkv, b_qkv, qkv, p.qkv, dt, stream)
    err = _lib.lib().dm_attention_core(
        _DTYPE_CODES[dt], qkv, core, n, t, num_heads, e // num_heads, p.core.stages,
        p.core.smem, stream)
    _lib.check(err, "fused_attention (core)")
    _gemm_bias(core, n * t, e, w_out, b_out, out.data_ptr(), p.out, dt, stream)
    LAUNCHES += 1
    return out


@torch.library.custom_op("dm_port::fused_attention", mutates_args=())
def fused_attention_op(x: torch.Tensor, w_qkv: torch.Tensor, b_qkv: torch.Tensor,
                       w_out: torch.Tensor, b_out: torch.Tensor, num_heads: int) -> torch.Tensor:
    """K2 as a registered op, so that ``torch.export`` records the call
    instead of tracing the ``ctypes`` launches: its body is
    :func:`fused_attention` (the kernels on CUDA, the plain version on CPU)."""
    return fused_attention(x, w_qkv, b_qkv, w_out, b_out, num_heads)


@fused_attention_op.register_fake
def _fused_attention_fake(x, w_qkv, b_qkv, w_out, b_out, num_heads):
    return torch.empty_like(x)

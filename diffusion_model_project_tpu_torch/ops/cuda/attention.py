"""K2: multi-head self-attention, hand-written CUDA kernels (``csrc/attention.cu``).

Replaces ``diffusion_model_project_tpu/ops/pallas/attention.py::fused_attention``.
One call launches three kernels: the QKV projection (GEMM + bias), the
attention core and the output projection (GEMM + bias). On a CUDA tensor
the wrapper launches them or raises; on a CPU tensor it takes the plain
version (``ops/attention.multihead_attention``).

Every shape runs: any T, any head dim. In bf16 the core is the wgmma
kernel at head dims 32, 64, 128, 256 and 512 (the published UNet's are
128, 256 and 512, and they run as they are); the wrapper runs any other
head dim up to 512 at the next of them, and past 512 at a multiple of 8 on
the SIMT core, through zero-padded copies of the weights (and of x, where E
is not a multiple of 8), sliced back after the output GEMM. float32 runs
the SIMT GEMM and the SIMT core, which take any shape as it is. In bf16 the
kernels read their operands with TMA, so every tensor they read must start
on a 16-byte boundary with rows a multiple of 16 bytes; the wrapper checks
both and raises otherwise. :func:`plan` picks each launch's tile, ring
stages and shared memory; it is plain Python, so the CPU tests hold it to
the card's limits.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..attention import multihead_attention
from . import _lib
from ._sm90 import ALIGN_SLACK, SMEM_LIMIT, SMS, cdiv

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# head dims of the bf16 wgmma core's instances; the wrapper runs any other hd
# up to 512 at the next one through zero-padded weights
HEAD_DIMS = (32, 64, 128, 256, 512)
# column chunks of the SIMT core (float32 at every hd, bf16 past 512)
SIMT_CHUNKS = HEAD_DIMS
SIMT_BQ, SIMT_BKV = 16, 32  # its query rows a block and keys a tile
MAX_BATCH = 65535  # the cores' grid.z
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
    simt: int   # 0: the bf16 wgmma core; else the SIMT core's column chunk
    stages: int  # ring stages of the wgmma core (0 for the SIMT core)
    smem: int
    grid: tuple  # wgmma: (64-query tiles, heads, samples); SIMT: (16-query
    #              tiles, heads x column splits, samples)


class Plan(NamedTuple):
    qkv: GemmPlan
    core: CorePlan
    out: GemmPlan
    hd: int  # the head dim the kernels see: hd, or hd zero-padded (bf16)
    ex: int  # the columns of x and of the output they see: E, or E padded to 8 (bf16)


def gemm_smem(bm: int, bn: int, stages: int) -> int:
    """Bytes of the GEMM's ring (A and B boxes of 64 K columns), its bf16
    epilogue tile (rows padded by 8) and its barriers (``csrc`` ``gemm_smem``)."""
    return ALIGN_SLACK + stages * (bm + bn) * 64 * 2 + bm * (bn + 8) * 2 + 16 * stages


def core_smem(hd: int, stages: int) -> int:
    """Bytes of the core's Q tile and ring of K/V tiles, 64 rows by
    max(hd, 64) columns each, and its barriers (``csrc`` ``core_smem``)."""
    return ALIGN_SLACK + 64 * max(hd, 64) * 2 * (1 + stages) + 8 * (2 * stages + 1)


def simt_smem(chunk: int) -> int:
    """Bytes of the SIMT core's Q and K/V tiles (rows of ``chunk`` + 1 float32
    columns), its score tile and its row statistics (``csrc`` ``simt_smem``)."""
    return 4 * ((SIMT_BQ + SIMT_BKV) * (chunk + 1) + SIMT_BQ * (SIMT_BKV + 1) + 3 * SIMT_BQ)


def plan_gemm(m: int, n: int) -> GemmPlan:
    """The largest tile that still gives every SM a block, else the one with the most."""
    for bm, bn in GEMM_TILES:
        grid = (cdiv(m, bm), cdiv(n, bn))
        if grid[0] * grid[1] >= SMS:
            break
    return GemmPlan(bm, bn, GEMM_STAGES, gemm_smem(bm, bn, GEMM_STAGES), grid)


def plan_core(n: int, t: int, hd: int, heads: int) -> CorePlan:
    """The bf16 wgmma core at one of ``HEAD_DIMS``."""
    tile = 64 * max(hd, 64) * 2
    stages = min(CORE_MAX_STAGES, (SMEM_LIMIT - core_smem(hd, 0)) // (tile + 16))
    return CorePlan(0, stages, core_smem(hd, stages), (cdiv(t, 64), heads, n))


def plan_simt(n: int, t: int, hd: int, heads: int) -> CorePlan:
    """The SIMT core: the smallest chunk that holds hd, else 512-column
    chunks, with the output columns split over ceil(hd / 512) blocks."""
    chunk = next((c for c in SIMT_CHUNKS if c >= hd), SIMT_CHUNKS[-1])
    return CorePlan(chunk, 0, simt_smem(chunk),
                    (cdiv(t, SIMT_BQ), heads * cdiv(hd, chunk), n))


def padded_head_dim(hd: int, bf16: bool) -> int:
    """The head dim K2's kernels run for ``hd``: hd itself in float32 (the
    SIMT core takes any); in bf16 the next wgmma instance up to 512, past
    that hd rounded up to 8 (the GEMMs' rows must be multiples of 16 bytes)."""
    if not bf16:
        return hd
    if hd <= HEAD_DIMS[-1]:
        return next(c for c in HEAD_DIMS if c >= hd)
    return -(-hd // 8) * 8


@functools.lru_cache(maxsize=64)
def plan(n: int, t: int, e: int, heads: int, dtype: torch.dtype = torch.bfloat16) -> Plan:
    """Launch plans of one call on (N, T, E) with ``heads`` heads in
    ``dtype``: the QKV GEMM, the core and the output GEMM, and the head dim
    and x columns they run at. Raises only for E not divisible by the heads
    or N past the cores' grid. Cached (the plans are immutable): a DDIM loop
    meets the same three shapes in every step."""
    if heads < 1 or e % heads != 0:
        raise ValueError(f"embed dim {e} not divisible by {heads} heads")
    if not (1 <= t and 1 <= n <= MAX_BATCH):
        raise ValueError(f"fused_attention: (N, T) = {(n, t)} outside the kernel's range")
    bf16 = dtype == torch.bfloat16
    hd = e // heads
    hdp = padded_head_dim(hd, bf16)
    ex = -(-e // 8) * 8 if bf16 else e
    if bf16 and hdp <= HEAD_DIMS[-1]:
        core = plan_core(n, t, hdp, heads)
    else:
        core = plan_simt(n, t, hdp, heads)
    ep = heads * hdp
    return Plan(plan_gemm(n * t, 3 * ep), core, plan_gemm(n * t, ex), hdp, ex)


def pad_heads(x, w_qkv, b_qkv, w_out, b_out, heads: int, hd: int, ex: int):
    """Zero-padded copies for heads of ``hd`` columns and x of ``ex``
    columns: w_qkv (ex, 3 H hd), b_qkv (3 H hd,), w_out (H hd, ex),
    b_out (ex,). Zero columns of Q and K add nothing to QK^T; zero columns
    of V give outputs that the zero rows of w_out drop; x's zero columns
    meet zero rows of w_qkv, and the output's extra columns are sliced off."""
    e = x.shape[-1]
    hd0 = e // heads
    wq = w_qkv.new_zeros((ex, 3, heads, hd))
    wq[:e, :, :, :hd0] = w_qkv.reshape(e, 3, heads, hd0)
    bq = b_qkv.new_zeros((3, heads, hd))
    bq[:, :, :hd0] = b_qkv.reshape(3, heads, hd0)
    wo = w_out.new_zeros((heads, hd, ex))
    wo[:, :hd0, :e] = w_out.reshape(heads, hd0, e)
    bo = b_out.new_zeros((ex,))
    bo[:e] = b_out
    if ex != e:
        x = torch.nn.functional.pad(x, (0, ex - e))
    return (x, wq.reshape(ex, 3 * heads * hd), bq.reshape(-1), wo.reshape(heads * hd, ex), bo)


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
    # the float32 kernels read through plain loads: rows of any length
    rows_ok = t.dtype != torch.bfloat16 or (row_elems * t.element_size()) % 16 == 0
    if t.data_ptr() % 16 or not rows_ok:
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
    p = plan(n, t, e, num_heads, dt)
    padded = p.hd != e // num_heads or p.ex != e
    if padded:
        x, w_qkv, b_qkv, w_out, b_out = pad_heads(x, w_qkv, b_qkv, w_out, b_out, num_heads,
                                                  p.hd, p.ex)
    ep = num_heads * p.hd
    _check_tma(x, p.ex, "x")
    stream = _lib.stream_ptr(x)
    # qkv (N, T, 3 ep), then the core's output (N, T, ep), in one scratch
    # buffer; the core's part starts 3 N T ep elements in, 16-byte aligned as
    # ep is a multiple of 8 in bf16
    rows = n * t
    scratch = torch.empty(4 * rows * ep, dtype=dt, device=dev)
    qkv, core = scratch.data_ptr(), scratch.data_ptr() + 3 * rows * ep * x.element_size()
    out = torch.empty((n, t, p.ex), dtype=dt, device=dev)
    _gemm_bias(x.data_ptr(), rows, p.ex, w_qkv, b_qkv, qkv, p.qkv, dt, stream)
    err = _lib.lib().dm_attention_core(
        _DTYPE_CODES[dt], qkv, core, n, t, num_heads, p.hd, 1.0 / math.sqrt(e // num_heads),
        p.core.simt, p.core.stages, p.core.smem, stream)
    _lib.check(err, "fused_attention (core)")
    _gemm_bias(core, rows, ep, w_out, b_out, out.data_ptr(), p.out, dt, stream)
    LAUNCHES += 1
    return out[..., :e].contiguous() if p.ex != e else out


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

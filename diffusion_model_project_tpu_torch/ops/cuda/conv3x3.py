"""K3: 3x3 stride-1 "same" convolution, hand-written CUDA kernel (``csrc/conv3x3.cu``).

Replaces ``scripts/perf_probe_conv.py::make_pallas_conv``, the TPU probe's
nine-shift Pallas conv. Layouts are the probe's: x ``(N, H, W, Cin)``,
w ``(3, 3, Cin, Cout)`` (HWIO), y ``(N, H, W, Cout)``. On a CUDA tensor the
wrapper launches the kernel or raises; on a CPU tensor it takes the plain
version.

In bf16 the kernel (``conv3x3_sm90``) reads x and W and writes y with TMA,
so Cin and Cout must be multiples of 8 (16-byte rows) and x and w must
start on a 16-byte boundary; the wrapper raises otherwise. :func:`plan`
picks the launch's tile, ring stages, shared memory and persistent grid; it
is plain Python, so the CPU tests hold it to the card's limits.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import _lib
from ._sm90 import ALIGN_SLACK, SMS, cdiv, sm_count

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# output pixels (TH, TW) a block owns, one compiled instance each: bf16
# (conv3x3_sm90) and float32 (conv3x3_f32) in the same order
TILES = ((8, 16), (16, 16), (32, 8))
F32_TILES = ((8, 16), (16, 16), (4, 32))
# the plan's tile: 146 operations per L2 byte (32 x 8 has 150, 8 x 16 90); on
# an H100 the three tiles run within about a tenth of each other (PERF.md)
PLAN_TILE = (16, 16)
BN = 128                 # output channels a tile (bf16)
# ring stages, compiled into the kernel (csrc STAGES_A, STAGES_B)
STAGES_A = 3             # halo boxes in flight
STAGES_B = 5             # weight slices in flight (the most beside a 256-pixel tile's halos)
MAX_BOX = 256            # the longest side of a TMA box
_B_BYTES = 64 * BN * 2   # a 64 Cin x 128 Cout weight slice
_MAX_TILES = 2 ** 31 - 1

# wrapper calls that launched the kernel (not counting CPU calls)
LAUNCHES = 0


@dataclass(frozen=True)
class ConvPlan:
    tile: tuple      # (TH, TW) output pixels a tile
    bn: int          # output channels a tile
    stages_a: int    # halo ring stages
    stages_b: int    # weight ring stages
    smem: int        # dynamic shared memory bytes
    tiles: int       # output tiles: pixel tiles x Cout blocks
    grid: int        # persistent blocks, at most one per SM


def halo_bytes(th: int, tw: int) -> int:
    """One halo box: (TH+2) x TW pixels x 64 channels in bf16."""
    return (th + 2) * tw * 128


def conv_smem(th: int, tw: int, stages_a: int, stages_b: int) -> int:
    """Bytes of the halo ring, the weight ring, the two warpgroups' epilogue
    boxes (their pixels x 64 channels) and the rings' barriers (``csrc``
    ``conv_smem``)."""
    return (ALIGN_SLACK + stages_a * halo_bytes(th, tw) + stages_b * _B_BYTES
            + th * tw * 128 + 16 * (stages_a + stages_b))


def ops_per_l2_byte(th: int, tw: int, bn: int = BN) -> float:
    """Operations a tile does per byte it moves from L2 into shared memory:
    per 64-channel chunk, 2 x 9 x 64 x BM x BN operations against 3 halo
    boxes ((TH+2) x TW x 128 bytes) and 9 weight slices (64 x BN x 2 bytes)."""
    return 9 / (9 / (th * tw) + 3 * (th + 2) / (th * bn))


@functools.lru_cache(maxsize=64)
def plan(n: int, h: int, w: int, cin: int, cout: int, tile=None, sms: int = SMS) -> ConvPlan:
    """Launch plan of the bf16 kernel on x (n, h, w, cin) -> cout channels
    at ``tile`` (default ``PLAN_TILE``) on a card of ``sms`` SMs. Raises
    outside the kernel's range."""
    if min(n, h, w, cin, cout) < 1:
        raise ValueError(f"conv3x3: empty shape {(n, h, w, cin)} -> {cout}")
    if cin % 8 or cout % 8:
        raise ValueError(f"conv3x3: bf16 needs Cin and Cout multiples of 8 (16-byte rows for "
                         f"TMA), got {cin} and {cout}")
    tile = tile or PLAN_TILE
    if tile not in TILES:
        raise ValueError(f"conv3x3: tile {tile} not in {TILES}")
    th, tw = tile
    tiles = n * cdiv(h, th) * cdiv(w, tw) * cdiv(cout, BN)
    if tiles > _MAX_TILES or max(n, h, w) >= 2 ** 31:
        raise ValueError(f"conv3x3: {(n, h, w, cin)} -> {cout} is outside the kernel's range")
    return ConvPlan(tile, BN, STAGES_A, STAGES_B, conv_smem(th, tw, STAGES_A, STAGES_B), tiles,
                    min(tiles, sms))


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's arithmetic: zero-pad, nine shifted ``[pix, Cin] @ [Cin, Cout]``
    products summed in float32, one cast to x's dtype."""
    n, h, wd, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = torch.zeros((n, h, wd, w.shape[3]), dtype=torch.float32, device=x.device)
    for di in range(3):
        for dj in range(3):
            acc += xp[:, di:di + h, dj:dj + wd, :] @ wf[di, dj]
    return acc.to(x.dtype)


def conv3x3(x: torch.Tensor, w: torch.Tensor, tile=None) -> torch.Tensor:
    """3x3 conv, zero "same" padding, NHWC x HWIO -> NHWC. ``tile`` is one of
    ``TILES``, the bf16 kernel's (by default :func:`plan`'s); float32 takes
    the ``F32_TILES`` entry at the same index (by default the first)."""
    global LAUNCHES
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("conv3x3 has no backward; call it without grad")
    if x.ndim != 4 or w.ndim != 4 or w.shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(f"conv3x3: expected x (N, H, W, Cin) and w (3, 3, Cin, Cout), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"conv3x3: x and w must share a float32 or bfloat16 dtype, got "
                        f"{x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError("conv3x3: w must be on x's device")
    if tile is not None and tile not in TILES:
        raise ValueError(f"conv3x3: tile {tile} not in {TILES}")
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3: x and w must be contiguous")
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    smem = grid = 0  # float32 plans its own launch
    if x.dtype == torch.bfloat16:
        p = plan(n, h, wd, cin, cout, tile, sm_count(x.device.index))
        if x.data_ptr() % 16 or w.data_ptr() % 16:
            raise ValueError("conv3x3: bf16 x and w must start on a 16-byte boundary (TMA)")
        tile, smem, grid = p.tile, p.smem, p.grid
    else:
        th, tw = F32_TILES[TILES.index(tile or TILES[0])]
        # grid.x counts images x tiles, grid.y blocks of 64 channels; sizes
        # are 32-bit ints in the kernel, offsets 64-bit
        if n * cdiv(h, th) * cdiv(wd, tw) >= 2 ** 31 or max(h, wd, cin) >= 2 ** 31 \
                or cout > 65535 * 64:
            raise ValueError(f"conv3x3: {tuple(x.shape)} -> {cout} is outside the kernel's range")
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    err = _lib.lib().dm_conv3x3(
        _DTYPE_CODES[x.dtype], TILES.index(tile or TILES[0]), x.data_ptr(), w.data_ptr(),
        y.data_ptr(), n, h, wd, cin, cout, smem, grid, _lib.stream_ptr(x))
    _lib.check(err, "conv3x3")
    LAUNCHES += 1
    return y

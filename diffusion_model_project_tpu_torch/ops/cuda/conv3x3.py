"""K3: 3x3 stride-1 "same" convolution, hand-written CUDA kernel (``csrc/conv3x3.cu``).

Replaces ``scripts/perf_probe_conv.py::make_pallas_conv``, the TPU probe's
nine-shift Pallas conv. Layouts are the probe's: x ``(N, H, W, Cin)``,
w ``(3, 3, Cin, Cout)`` (HWIO), y ``(N, H, W, Cout)``. On a CUDA tensor the
wrapper launches the kernel or raises; on a CPU tensor it takes the plain
version.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _lib

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# output pixels (TH, TW) a block owns, one compiled instance each
TILES = ((8, 16), (16, 16), (4, 32))

# wrapper calls that launched the kernel (not counting CPU calls)
LAUNCHES = 0


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


def conv3x3(x: torch.Tensor, w: torch.Tensor, tile=TILES[0]) -> torch.Tensor:
    """3x3 conv, zero "same" padding, NHWC x HWIO -> NHWC; ``tile`` is one of ``TILES``."""
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
    if tile not in TILES:
        raise ValueError(f"conv3x3: tile {tile} not in {TILES}")
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3: x and w must be contiguous")
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    th, tw = tile
    # grid.x counts images x tiles, grid.y blocks of 64 (float32) or 128
    # channels; sizes are 32-bit ints in the kernel, offsets 64-bit
    if n * -(-h // th) * -(-wd // tw) >= 2 ** 31 or max(h, wd, cin) >= 2 ** 31 \
            or cout > 65535 * 64:
        raise ValueError(f"conv3x3: {tuple(x.shape)} -> {cout} is outside the kernel's range")
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    err = _lib.lib().dm_conv3x3(
        _DTYPE_CODES[x.dtype], TILES.index(tile), x.data_ptr(), w.data_ptr(), y.data_ptr(),
        n, h, wd, cin, cout, _lib.stream_ptr(x))
    _lib.check(err, "conv3x3")
    LAUNCHES += 1
    return y

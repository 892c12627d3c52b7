"""Resize primitives with torch ``interpolate`` semantics (channels-first).

Counterpart of the JAX ``ops/resize.py``: separable gather+lerp with the
``align_corners=False`` source rule ``src = (i + 0.5) * in/out - 0.5``
clamped at 0, no antialias on downsampling, lerp in float32.
"""
from __future__ import annotations

import torch


def _resize_axis_linear(x: torch.Tensor, dim: int, out_size: int) -> torch.Tensor:
    """1D linear resize along ``dim`` with align_corners=False, no antialias."""
    if not x.is_floating_point():
        raise TypeError(f"linear resize requires a floating dtype, got {x.dtype}")
    in_size = x.shape[dim]
    if in_size == out_size:
        return x
    scale = in_size / out_size
    src = (torch.arange(out_size, dtype=torch.float32, device=x.device) + 0.5) * scale - 0.5
    src = torch.clamp(src, min=0.0)
    i0 = torch.clamp(torch.floor(src).to(torch.int64), max=in_size - 1)
    i1 = torch.clamp(i0 + 1, max=in_size - 1)
    wdtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    shape = [1] * x.ndim
    shape[dim] = out_size
    w1 = (src - i0.to(torch.float32)).to(wdtype).reshape(shape)
    x0 = torch.index_select(x, dim, i0).to(wdtype)
    x1 = torch.index_select(x, dim, i1).to(wdtype)
    return (x0 + w1 * (x1 - x0)).to(x.dtype)


def interpolate_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of ``(N, C, H, W)`` to ``(N, C, out_h, out_w)``."""
    x = _resize_axis_linear(x, 2, out_h)
    return _resize_axis_linear(x, 3, out_w)


def interpolate_trilinear(x: torch.Tensor, out_d: int, out_h: int, out_w: int) -> torch.Tensor:
    """Trilinear resize of ``(N, C, D, H, W)``."""
    x = _resize_axis_linear(x, 2, out_d)
    x = _resize_axis_linear(x, 3, out_h)
    return _resize_axis_linear(x, 4, out_w)


def upsample_nearest_hw(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsample of H and W only, on ``(N, C, D, H, W)``."""
    return x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)

"""Core elementwise / normalization / pooling primitives (channels-first).

Counterpart of ``diffusion_model_project_tpu/ops/basic.py``. 2D feature maps
are ``(N, C, H, W)``, 3D volumes ``(N, C, D, H, W)``, so one GroupNorm group
is one contiguous span of ``(C/G) * prod(spatial)`` elements. The samplers
store them channels-last on the card (:func:`to_channels_last`); every op
here gives its output in its input's layout.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def get_padding(kernel_size: int) -> int:
    """'Same-ish' padding for a given kernel size (even k -> k/2-1, odd -> k//2)."""
    if kernel_size % 2 == 0:
        return kernel_size // 2 - 1
    return kernel_size // 2


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


_ACTIVATIONS: dict = {
    "silu": silu,
    "relu": torch.relu,
    "leakyrelu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "softplus": F.softplus,
}


def activation_function(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    """Explicit activation registry; '' or None is the identity."""
    if name is not None:
        name = name.strip().lower()
    if not name:
        return lambda x: x
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise NotImplementedError(f"Unknown activation: {name!r}")


def memory_format(x: torch.Tensor) -> torch.memory_format:
    """x's layout: ``torch.channels_last`` / ``channels_last_3d`` where x is
    stored so and is not also contiguous, else ``torch.contiguous_format``."""
    if x.dim() in (4, 5) and not x.is_contiguous():
        fmt = torch.channels_last if x.dim() == 4 else torch.channels_last_3d
        if x.is_contiguous(memory_format=fmt):
            return fmt
    return torch.contiguous_format


def to_channels_last(x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (N, C, H, W) or (N, C, D, H, W) in ``dtype`` (default x's), stored
    channels-last and dense, with channel stride 1 also where the two layouts
    coincide (C = 1), so that ``torch.cat`` along the channels keeps the
    layout. A cast and a layout change are one copy; x itself where it is
    stored so already."""
    fmt = torch.channels_last if x.dim() == 4 else torch.channels_last_3d
    return x.to(dtype or x.dtype, memory_format=fmt).contiguous(memory_format=fmt)


def group_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
    two_pass: bool = False,
) -> torch.Tensor:
    """GroupNorm over channels-first input ``(N, C, *spatial)``.

    Statistics per (sample, group) in float32. ``two_pass=False`` is the
    inference form (sum and sum of squares in one read, variance clamped at
    0); ``two_pass=True`` is the robust mean-then-E[(x-mean)^2] form used for
    training. Output is in the input dtype and layout.
    """
    n, c = x.shape[0], x.shape[1]
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    xf = x.contiguous().reshape(n, num_groups, -1).float()  # channels-first order
    if two_pass:
        mean = xf.mean(dim=2)
        var = (xf - mean[..., None]).square().mean(dim=2)
    else:
        cnt = xf.shape[2]
        mean = xf.sum(dim=2) / cnt
        var = torch.clamp(xf.square().sum(dim=2) / cnt - mean.square(), min=0.0)
    scale = torch.rsqrt(var + eps)
    out = ((xf - mean[..., None]) * scale[..., None]).reshape(x.shape)
    shape = (1, c) + (1,) * (x.ndim - 2)
    out = (out * gamma.float().reshape(shape) + beta.float().reshape(shape)).to(x.dtype)
    fmt = memory_format(x)
    return out if fmt == torch.contiguous_format else out.contiguous(memory_format=fmt)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pooling on ``(N, C, H, W)`` (floor semantics)."""
    return F.max_pool2d(x, 2)

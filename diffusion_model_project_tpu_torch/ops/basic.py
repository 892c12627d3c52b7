"""Core elementwise / normalization / pooling primitives (channels-first).

Counterpart of ``diffusion_model_project_tpu/ops/basic.py``. 2D feature maps
are ``(N, C, H, W)``, 3D volumes ``(N, C, D, H, W)``, so one GroupNorm group
is one contiguous span of ``(C/G) * prod(spatial)`` elements.
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
    training. Output is in the input dtype.
    """
    n, c = x.shape[0], x.shape[1]
    if c % num_groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    xf = x.reshape(n, num_groups, -1).float()
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
    out = out * gamma.float().reshape(shape) + beta.float().reshape(shape)
    return out.to(x.dtype)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pooling on ``(N, C, H, W)`` (floor semantics)."""
    return F.max_pool2d(x, 2)

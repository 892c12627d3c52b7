"""Layers with the reference's parameter layouts, channels-first.

Counterpart of the JAX ``models/layers.py``. Parameters are kept in float32
and cast to the input's dtype at each call, as the JAX layers do, so the
compute dtype touches only conv and matmul compute. GroupNorm(+act) and
self-attention go through the K1/K2 wrappers, which launch the hand-written
kernels on CUDA tensors and take the plain versions on CPU tensors.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.basic import activation_function
from ..ops.cuda.attention import fused_attention
from ..ops.cuda.groupnorm_act import groupnorm_act


def _cast(p: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if p is None else p.to(dtype)


class Conv2d(nn.Conv2d):
    """torch Conv2d (padding modes zeros/reflect/replicate/circular) run in x's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class Conv3d(nn.Conv3d):
    """torch Conv3d run in x's dtype. ``extra_pad`` = per-dim (lo, hi) zero
    pre-padding for (D, H, W), for the VAE's stride-(1,2,2) downsampling that
    pads D:1,1 | H:0,1 | W:0,1."""

    def __init__(self, *args, extra_pad: Optional[Sequence[Sequence[int]]] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.extra_pad = None
        if extra_pad is not None:
            # F.pad lists the last dim first
            self.extra_pad = tuple(v for lo_hi in reversed(extra_pad) for v in lo_hi)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.extra_pad is not None:
            x = F.pad(x, self.extra_pad)
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class ConvTranspose2x2(nn.ConvTranspose2d):
    """ConvTranspose2d(kernel=2, stride=2); weight (in, out, 2, 2)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype), stride=2)


class Linear(nn.Linear):
    """Linear (weight (out, in)) run in x's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class Activation(nn.Module):
    """Parameter-free activation by registry name ('' is the identity)."""

    def __init__(self, name: Optional[str]):
        super().__init__()
        self.fn = activation_function(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


class GroupNorm(nn.Module):
    """GroupNorm (eps=1e-5, affine) + optional fused 'silu'/'relu' activation,
    through the K1 wrapper. Statistics are float32 whatever x's dtype."""

    def __init__(self, num_groups: int, num_channels: int, act: str = ""):
        super().__init__()
        if act not in ("", "silu", "relu"):
            raise NotImplementedError(f"GroupNorm fused activation {act!r}")
        self.num_groups = num_groups
        self.act = act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return groupnorm_act(x, self.weight, self.bias, self.num_groups, self.act)


class MultiheadSelfAttention(nn.Module):
    """Self-attention with torch MultiheadAttention semantics (batch_first) on (N, T, E),
    with its parameter names, through the K2 wrapper."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        # transposed views give the (E, 3E) / (E, E) layouts without a copy
        return fused_attention(
            x, self.in_proj_weight.t().to(dt), self.in_proj_bias.to(dt),
            self.out_proj.weight.t().to(dt), self.out_proj.bias.to(dt), self.num_heads)


# --------------------------------------------------------------- initializers
# The JAX package's flax initializers, drawn from an explicit torch.Generator.

def uniform_(p: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)


def fan_in_uniform_(p: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """variance_scaling(1/3, fan_in, uniform) = torch's kaiming_uniform(a=sqrt(5))."""
    uniform_(p, 1.0 / math.sqrt(fan_in), generator)


def init_layer_(m: nn.Module, generator: torch.Generator) -> None:
    """Initialize one layer as its JAX counterpart does (biases zero, GN affine
    identity, MHA in_proj xavier-uniform)."""
    if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.Linear)):
        # fan-in is size(1) * kernel size; for the transposed conv's (in, out,
        # kH, kW) weight that is the OUT channels, as torch (and the JAX init) read it
        w = m.weight
        fan_in_uniform_(w, w.shape[1] * math.prod(w.shape[2:]), generator)
        if m.bias is not None:
            nn.init.zeros_(m.bias)
    elif isinstance(m, GroupNorm):
        nn.init.ones_(m.weight)
        nn.init.zeros_(m.bias)
    elif isinstance(m, MultiheadSelfAttention):
        e3, e = m.in_proj_weight.shape
        uniform_(m.in_proj_weight, math.sqrt(6.0 / (e + e3)), generator)
        nn.init.zeros_(m.in_proj_bias)


def init_module_(module: nn.Module, generator: torch.Generator) -> None:
    for m in module.modules():
        init_layer_(m, generator)

"""Layers with the reference's parameter layouts, channels-first.

Counterpart of the JAX ``models/layers.py``. Parameters are kept in float32
and cast to the input's dtype at each call, as the JAX layers do, so the
compute dtype touches only conv and matmul compute. Each layer gives its
output in its input's layout: on channels-last input (the samplers' on the
card) a conv's weight cast writes the weight channels-last too, and a
padding mode other than zeros pads the (N, H, W, C) view, so that cuDNN
transposes nothing. GroupNorm(+act) and
self-attention go through the K1/K2 wrappers, which launch the hand-written
kernels on CUDA tensors and take the plain versions on CPU tensors. Inside
``train_trace()`` (the training steps) a call that needs a gradient takes the
plain version under autograd instead, GroupNorm with two-pass statistics.
Inside ``int8_convs()`` (a frozen predictor's int8 paths) ``Conv2d`` and
``Conv3d`` run dynamic int8 through ``ops/quant.int8_conv`` (K4), except the
thin-channel ones that ``ops/quant.use_float_path`` keeps in float.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multihead_attention
from ..ops.basic import activation_function, group_norm, memory_format
from ..ops.cuda.attention import fused_attention
from ..ops.cuda.groupnorm_act import groupnorm_act
from ..ops.quant import int8_conv, use_float_path

# Set by train_trace(). A process-wide flag, not a thread-local one: the
# autograd engine runs backward (and torch.utils.checkpoint's recomputation
# of the VAE's residual blocks) on threads of its own, which must route the
# same way as the forward did.
_TRAIN_TRACE = False


@contextlib.contextmanager
def train_trace():
    """The switches of a training step (the JAX ``train_trace()``, without
    its TPU-only conv3d variant): a GroupNorm or self-attention call that
    needs a gradient takes the plain version under autograd, GroupNorm with
    robust two-pass statistics (one-pass E[x^2]-mu^2 loses the variance once
    training drifts activations to |mean|/std > ~3e3); K1 and K2, which have
    no backward, are not launched for it. Calls that need none (the frozen
    encodes of the target and the 2D input) still launch them: K1's
    statistics are Chan's merge, robust as well. Enter it around the forward
    AND ``loss.backward()``. Outside it nothing changes: the wrappers still
    raise under grad on CUDA."""
    global _TRAIN_TRACE
    prev = _TRAIN_TRACE
    _TRAIN_TRACE = True
    try:
        yield
    finally:
        _TRAIN_TRACE = prev


def in_train_trace() -> bool:
    return _TRAIN_TRACE


def routes_plain(module: nn.Module, x: torch.Tensor) -> bool:
    """Whether ``module``'s call on ``x`` takes the plain version under
    autograd: inside ``train_trace()``, where x or a parameter needs a gradient."""
    return _TRAIN_TRACE and torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in module.parameters()))


# Set by int8_convs(). Thread-local: the server's batcher thread may run an
# int8 predictor while other threads run a float one. int8 never trains, so
# no autograd thread has to see it.
_INT8 = threading.local()


@contextlib.contextmanager
def int8_convs():
    """Every ``Conv2d`` / ``Conv3d`` called inside this context on this thread
    runs dynamic int8 (the JAX ``int8_convs()``), unless its channels are too
    thin (``use_float_path``)."""
    prev = in_int8_convs()
    _INT8.on = True
    try:
        yield
    finally:
        _INT8.on = prev


def in_int8_convs() -> bool:
    return getattr(_INT8, "on", False)


def routes_int8(conv: nn.Module) -> bool:
    """Whether a call of ``conv`` (a Conv2d or Conv3d) takes the int8 path."""
    return in_int8_convs() and not use_float_path(conv.in_channels, conv.out_channels)


def _conv_int8(conv, x: torch.Tensor, extra_pad=None) -> torch.Tensor:
    """The JAX ``Conv`` under ``int8_convs()``: ``extra_pad`` (per-dim (lo,
    hi)) joins the padding, a padding mode other than zeros pads x first, then
    the int8 conv rescales to x's dtype and the bias is added in that dtype."""
    pads = [(p, p) for p in conv.padding]
    if extra_pad is not None:
        pads = [(a + c, b + d) for (a, b), (c, d) in zip(pads, extra_pad)]
    if conv.padding_mode != "zeros" and any(p != (0, 0) for p in pads):
        x = _pad(x, [v for lo_hi in reversed(pads) for v in lo_hi], conv.padding_mode)
        pads = [(0, 0)] * len(pads)
    out = _in_layout(int8_conv(x, conv.weight, conv.stride, pads, x.dtype), memory_format(x))
    if conv.bias is None:
        return out
    return out + conv.bias.to(out.dtype).reshape((-1,) + (1,) * (out.ndim - 2))


def _pad(x: torch.Tensor, pad: Sequence[int], mode: str) -> torch.Tensor:
    """``F.pad(x, pad, mode)`` in x's layout. On channels-last 4-D x the
    pad runs on the (N, H, W, C) view with the channels unpadded (CUDA's
    reflection and replication pads of 4-D x return channels-first)."""
    if x.dim() != 4 or memory_format(x) == torch.contiguous_format:
        return F.pad(x, pad, mode=mode)
    return F.pad(x.permute(0, 2, 3, 1), (0, 0, *pad), mode=mode).permute(0, 3, 1, 2)


def _weight(w: torch.Tensor, fmt: torch.memory_format, dtype: torch.dtype) -> torch.Tensor:
    """A conv's weight cast to ``dtype``, laid out as ``fmt`` in the same copy."""
    return w.to(dtype, memory_format=fmt)


def _in_layout(out: torch.Tensor, fmt: torch.memory_format) -> torch.Tensor:
    """A conv's output in its input's layout ``fmt``: cuDNN's float32 and
    bf16 convs give it; float64 ones (and the CPU's 3-D ones) do not."""
    if fmt == torch.contiguous_format or out.is_contiguous(memory_format=fmt):
        return out
    return out.contiguous(memory_format=fmt)


def _cast(p: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if p is None else p.to(dtype)


class Conv2d(nn.Conv2d):
    """torch Conv2d (padding modes zeros/reflect/replicate/circular) run in x's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if routes_int8(self):
            return _conv_int8(self, x)
        fmt = memory_format(x)
        w, b = _weight(self.weight, fmt, x.dtype), _cast(self.bias, x.dtype)
        pad = self.padding
        if self.padding_mode != "zeros":
            x, pad = _pad(x, self._reversed_padding_repeated_twice, self.padding_mode), 0
        return _in_layout(F.conv2d(x, w, b, self.stride, pad, self.dilation, self.groups), fmt)


class Conv3d(nn.Conv3d):
    """torch Conv3d run in x's dtype. ``extra_pad`` = per-dim (lo, hi) zero
    pre-padding for (D, H, W), for the VAE's stride-(1,2,2) downsampling that
    pads D:1,1 | H:0,1 | W:0,1."""

    def __init__(self, *args, extra_pad: Optional[Sequence[Sequence[int]]] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.extra_pad = None
        self.extra_pad_pairs = None
        if extra_pad is not None:
            self.extra_pad_pairs = tuple(tuple(lo_hi) for lo_hi in extra_pad)
            # F.pad lists the last dim first
            self.extra_pad = tuple(v for lo_hi in reversed(extra_pad) for v in lo_hi)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if routes_int8(self):
            return _conv_int8(self, x, self.extra_pad_pairs)
        if self.extra_pad is not None:
            x = F.pad(x, self.extra_pad)
        fmt = memory_format(x)
        return _in_layout(self._conv_forward(x, _weight(self.weight, fmt, x.dtype),
                                             _cast(self.bias, x.dtype)), fmt)


class ConvTranspose2x2(nn.ConvTranspose2d):
    """ConvTranspose2d(kernel=2, stride=2); weight (in, out, 2, 2)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fmt = memory_format(x)
        return _in_layout(F.conv_transpose2d(x, _weight(self.weight, fmt, x.dtype),
                                             _cast(self.bias, x.dtype), stride=2), fmt)


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
        if routes_plain(self, x):
            return activation_function(self.act)(
                group_norm(x, self.weight, self.bias, self.num_groups, two_pass=True))
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
        attention = multihead_attention if routes_plain(self, x) else fused_attention
        return attention(
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

"""Conditional 2D UNet denoiser, channels-first.

Counterpart of the JAX ``models/unet.py``, with the reference's torch module
naming (``encoder.{k}.{0,1,2}``, ``bottleneck``, ``decoder.{k}.{0,1,2}``,
``final_conv``, ``time_mlp``) so a state dict exported from the JAX params
loads with ``strict=True``:
  - Block = Conv2d(bias=False) + GroupNorm(1) + activation
  - DoubleBlock = Block + time-embedding add + Block
  - Down = MaxPool2d(2) + GN(1) + act;  Up = ConvTranspose2d(2, 2) + GN(1) + act
  - SelfAttention2D = GN(1) + multi-head attention over H*W tokens + 1x1
    projection (a Conv1d parameter, applied as a linear map) + residual
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.basic import activation_function, get_padding, max_pool_2x2
from .layers import (Activation, Conv2d, ConvTranspose2x2, GroupNorm, Linear,
                     MultiheadSelfAttention, init_module_)


def eval_expression(expr: str, max_levels: int) -> List[Optional[int]]:
    """Parse the attention placement 'start.end.heads' ('3..2' = 2 heads from
    level 3 to the last; '' = none). Levels are 1-based."""
    expr = (expr or "").strip()
    out: List[Optional[int]] = [None] * max_levels
    if not expr:
        return out
    try:
        start_s, end_s, heads_s = expr.split(".")
        if not end_s.strip():
            end_s = str(max_levels)
        start, end, heads = int(start_s), int(end_s), int(heads_s)
        for i in range(start - 1, end):
            out[i] = heads
    except Exception as e:  # same contract as the reference
        raise ValueError("Check validity of expression string.") from e
    return out


def sinusoidal_time_embedding(time: torch.Tensor, dim: int) -> torch.Tensor:
    """(N,) timesteps -> (N, dim) sin/cos embedding, float32."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=time.device)
                      * -(math.log(10000.0) / (half - 1)))
    args = time.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def _fused(activation: str) -> str:
    return activation if activation in ("silu", "relu") else ""


class Block(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, padding_mode, activation):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size,
                           padding=get_padding(kernel_size), padding_mode=padding_mode,
                           bias=False)
        self.norm = GroupNorm(1, out_channels, act=_fused(activation))
        self.post = activation_function("" if _fused(activation) else activation)

    def forward(self, x):
        return self.post(self.norm(self.conv(x)))


class DoubleBlock(nn.Module):
    def __init__(self, in_channels, mid_channels, out_channels, kernel_size, padding_mode,
                 activation, time_dim: Optional[int] = None):
        super().__init__()
        self.block1 = Block(in_channels, mid_channels, kernel_size, padding_mode, activation)
        self.time_mlp = None
        if time_dim is not None:
            self.time_mlp = nn.Sequential(Activation(activation), Linear(time_dim, mid_channels))
        self.block2 = Block(mid_channels, out_channels, kernel_size, padding_mode, activation)

    def forward(self, x, time_emb=None):
        x = self.block1(x)
        if self.time_mlp is not None and time_emb is not None:
            x = x + self.time_mlp(time_emb)[:, :, None, None]
        return self.block2(x)


class Down(nn.Module):
    def __init__(self, channels, activation):
        super().__init__()
        self.norm = GroupNorm(1, channels, act=_fused(activation))
        self.post = activation_function("" if _fused(activation) else activation)

    def forward(self, x):
        return self.post(self.norm(max_pool_2x2(x)))


class Up(nn.Module):
    def __init__(self, in_channels, out_channels, activation):
        super().__init__()
        self.conv = ConvTranspose2x2(in_channels, out_channels)
        self.norm = GroupNorm(1, out_channels, act=_fused(activation))
        self.post = activation_function("" if _fused(activation) else activation)

    def forward(self, x):
        return self.post(self.norm(self.conv(x)))


class SelfAttention2D(nn.Module):
    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        self.norm = GroupNorm(1, channels)
        self.mha = MultiheadSelfAttention(channels, num_heads)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x):
        n, c, h, w = x.shape
        y = self.norm(x).reshape(n, c, h * w).transpose(1, 2).contiguous()
        y = self.mha(y)
        # the 1x1 projection lies outside the attention kernel: a plain linear map
        y = F.linear(y, self.proj_out.weight[..., 0].to(y.dtype), self.proj_out.bias.to(y.dtype))
        return x + y.transpose(1, 2).reshape(n, c, h, w)


class UNet(nn.Module):
    def __init__(
        self,
        in_channels: int = 9,
        out_channels: int = 4,
        features: Sequence[int] = (64, 128, 256, 512),
        kernel_size: int = 3,
        padding_mode: str = "reflect",
        activation: str = "silu",
        final_activation: Optional[str] = None,
        attention: str = "",
        dropout: float = 0.0,
        time_embedding_dim: Optional[int] = None,
    ):
        super().__init__()
        if dropout:
            raise NotImplementedError("dropout > 0 is a training option; not ported yet")
        features = list(features)
        heads = eval_expression(attention, len(features))
        self.time_embedding_dim = time_embedding_dim
        tdim = None
        if time_embedding_dim is not None:
            tdim = 4 * time_embedding_dim
            self.time_mlp = nn.Sequential(Linear(time_embedding_dim, tdim),
                                          Activation(activation), Linear(tdim, tdim))
        kw = dict(kernel_size=kernel_size, padding_mode=padding_mode, activation=activation)

        self.encoder = nn.ModuleList()
        ch = in_channels
        for k, f in enumerate(features):
            self.encoder.append(nn.ModuleList([
                DoubleBlock(ch, f, f, time_dim=tdim, **kw),
                SelfAttention2D(f, heads[k]) if heads[k] is not None else nn.Identity(),
                Down(f, activation),
            ]))
            ch = f
        f_bot = 2 * features[-1]
        self.bottleneck = DoubleBlock(ch, f_bot, f_bot, time_dim=tdim, **kw)
        ch = f_bot
        self.decoder = nn.ModuleList()
        for k, f in enumerate(reversed(features)):
            h_k = heads[::-1][k]
            self.decoder.append(nn.ModuleList([
                Up(ch, f, activation),
                DoubleBlock(2 * f, f, f, time_dim=tdim, **kw),
                SelfAttention2D(f, h_k) if h_k is not None else nn.Identity(),
            ]))
            ch = f
        self.final_conv = Conv2d(ch, out_channels, kernel_size,
                                 padding=get_padding(kernel_size), padding_mode=padding_mode)
        self.final_act = activation_function(final_activation)

    def init_parameters_(self, generator: torch.Generator) -> None:
        """The JAX init: fan-in uniform convs/linears, zero biases, identity GN,
        and zero ``final_conv`` and attention ``proj_out`` (identity blocks)."""
        init_module_(self, generator)
        nn.init.zeros_(self.final_conv.weight)
        nn.init.zeros_(self.final_conv.bias)
        for m in self.modules():
            if isinstance(m, SelfAttention2D):
                nn.init.zeros_(m.proj_out.weight)
                nn.init.zeros_(m.proj_out.bias)

    def forward(self, x: torch.Tensor, time: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (N, in_channels, H, W); time: (N,) integer timesteps."""
        time_emb = None
        if self.time_embedding_dim is not None:
            if time is None:
                raise ValueError("Model requires time input but None was provided")
            t = sinusoidal_time_embedding(time, self.time_embedding_dim).to(x.dtype)
            time_emb = self.time_mlp(t)
        skips = []
        for conv, attn, down in self.encoder:
            x = attn(conv(x, time_emb))
            skips.append(x)
            x = down(x)
        x = self.bottleneck(x, time_emb)
        for k, (up, conv, attn) in enumerate(self.decoder):
            x = torch.cat([skips[-1 - k], up(x)], dim=1)  # skip first, then x
            x = attn(conv(x, time_emb))
        return self.final_act(self.final_conv(x))

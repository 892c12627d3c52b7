"""Plain PyTorch forward passes of the published networks, from a dict of weights.

Written from the published architecture (the reference project's UNet and
dual-branch VAE), with its state-dict names: no module of the measured
program and no kernel of its own, only ``torch`` and ``torch.nn.functional``.
Everything runs in the dtype of the input (float32 for the reference; the
training control runs it under bfloat16 autocast).

UNet: Block = conv (no bias) + GroupNorm(1) + SiLU; DoubleBlock = Block +
SiLU-Linear(time embedding) + Block; Down = maxpool 2 + GN(1) + SiLU; Up =
ConvTranspose 2x2/2 + GN(1) + SiLU; SelfAttention2D = GN(1) + multi-head
attention over H*W tokens + 1x1 projection + residual; the decoder takes
cat(skip, up). VAE: ResidualBlock = GN(32)+SiLU, conv 3^3, GN(32)+SiLU, conv
3^3, 1^3 shortcut where the width changes; Encoder downsamples H and W with
stride (1,2,2) convs padded D 1/1, H 0/1, W 0/1; Decoder upsamples H and W
by nearest repetition.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def parse_attention(expr: str, levels: int) -> list:
    out = [None] * levels
    expr = (expr or "").strip()
    if expr:
        start, end, heads = expr.split(".")
        for i in range(int(start) - 1, int(end or levels)):
            out[i] = int(heads)
    return out


def gn(x, p, pre, groups, silu):
    y = F.group_norm(x, groups, p[pre + "weight"], p[pre + "bias"], eps=1e-5)
    return F.silu(y) if silu else y


def conv2d(x, p, pre, padding_mode="zeros", pad=1, bias=True):
    w = p[pre + "weight"]
    b = p[pre + "bias"] if bias else None
    if padding_mode != "zeros" and pad:
        return F.conv2d(F.pad(x, (pad,) * 4, mode=padding_mode), w, b)
    return F.conv2d(x, w, b, padding=pad)


def linear(x, p, pre):
    return F.linear(x, p[pre + "weight"], p[pre + "bias"])


def time_embedding(t, dim):
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def _double(p, pre, x, temb, u):
    pm, pad = u["padding_mode"], u["kernel_size"] // 2
    x = conv2d(x, p, pre + "block1.conv.", pm, pad, bias=False)
    x = gn(x, p, pre + "block1.norm.", 1, True)
    x = x + linear(F.silu(temb), p, pre + "time_mlp.1.")[:, :, None, None]
    x = conv2d(x, p, pre + "block2.conv.", pm, pad, bias=False)
    return gn(x, p, pre + "block2.norm.", 1, True)


def attention_tokens(y, p, pre, heads):
    """Multi-head self-attention of (N, T, E) tokens: torch MultiheadAttention's
    semantics, scores and softmax in float32."""
    n, t, e = y.shape
    hd = e // heads
    qkv = F.linear(y, p[pre + "in_proj_weight"], p[pre + "in_proj_bias"])
    q, k, v = (z.reshape(n, t, heads, hd).transpose(1, 2) for z in qkv.split(e, dim=-1))
    scores = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(hd)
    o = torch.matmul(torch.softmax(scores, dim=-1).to(v.dtype), v)
    return linear(o.transpose(1, 2).reshape(n, t, e), p, pre + "out_proj.")


def _attention(p, pre, x, heads):
    n, c, h, w = x.shape
    y = gn(x, p, pre + "norm.", 1, False).reshape(n, c, h * w).transpose(1, 2)
    y = attention_tokens(y, p, pre + "mha.", heads)
    y = F.linear(y, p[pre + "proj_out.weight"][..., 0], p[pre + "proj_out.bias"])
    return x + y.transpose(1, 2).reshape(n, c, h, w)


def unet(p: dict, u: dict, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """eps prediction of (N, in, H, W) at integer timesteps t (N,)."""
    feats = list(u["features"])
    heads = parse_attention(u["attention"], len(feats))
    temb = time_embedding(t, u["time_embedding_dim"]).to(x.dtype)
    temb = linear(F.silu(linear(temb, p, "time_mlp.0.")), p, "time_mlp.2.")
    skips = []
    for i in range(len(feats)):
        x = _double(p, f"encoder.{i}.0.", x, temb, u)
        if heads[i] is not None:
            x = _attention(p, f"encoder.{i}.1.", x, heads[i])
        skips.append(x)
        x = gn(F.max_pool2d(x, 2), p, f"encoder.{i}.2.norm.", 1, True)
    x = _double(p, "bottleneck.", x, temb, u)
    for i in range(len(feats)):
        up = F.conv_transpose2d(x, p[f"decoder.{i}.0.conv.weight"], p[f"decoder.{i}.0.conv.bias"],
                                stride=2)
        up = gn(up, p, f"decoder.{i}.0.norm.", 1, True)
        x = _double(p, f"decoder.{i}.1.", torch.cat([skips[-1 - i], up], dim=1), temb, u)
        if heads[::-1][i] is not None:
            x = _attention(p, f"decoder.{i}.2.", x, heads[::-1][i])
    return conv2d(x, p, "final_conv.", u["padding_mode"], u["kernel_size"] // 2)


def conv3d(x, p, pre, pad=1, stride=1):
    return F.conv3d(x, p[pre + "weight"], p[pre + "bias"], stride=stride, padding=pad)


def _res(p, pre, x, groups):
    h = conv3d(gn(x, p, pre + "norm1.", groups, True), p, pre + "conv1.")
    h = conv3d(gn(h, p, pre + "norm2.", groups, True), p, pre + "conv2.")
    if pre + "residual_layer.weight" in p:
        x = conv3d(x, p, pre + "residual_layer.", pad=0)
    return h + x


def _stage(p, pre, x, groups, remat):
    """Two residual blocks, each recomputed in backward where ``remat``."""
    for blk in ("_1.", "_2."):
        if remat and torch.is_grad_enabled():
            x = checkpoint(_res, p, pre + blk, x, groups, use_reentrant=False)
        else:
            x = _res(p, pre + blk, x, groups)
    return x


def _down(p, pre, x):
    return F.conv3d(F.pad(x, (0, 1, 0, 1, 1, 1)), p[pre + "weight"], p[pre + "bias"],
                    stride=(1, 2, 2))


def encoder(p: dict, v: dict, x: torch.Tensor, remat: bool = False):
    """(N, 3, D, H, W) -> mu, logvar (unclamped), each (N, latent, D, H/4, W/4)."""
    g = v["groups"]
    x = conv3d(x, p, "conv_in.")
    x = _down(p, "down1.", _stage(p, "res1", x, g, remat))
    x = _down(p, "down2.", _stage(p, "res2", x, g, remat))
    x = _stage(p, "res3", x, g, remat)
    x = conv3d(gn(x, p, "norm_out.", g, True), p, "conv_out.")
    return x.chunk(2, dim=1)


def _up(x):
    return x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)


def decoder(p: dict, v: dict, z: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """(N, latent, D, h, w) -> (N, 3, D, 4h, 4w)."""
    g = v["groups"]
    x = _stage(p, "res1", conv3d(z, p, "conv_in."), g, remat)
    x = _stage(p, "res2", conv3d(_up(x), p, "conv_up1."), g, remat)
    x = _stage(p, "res3", conv3d(_up(x), p, "conv_up2."), g, remat)
    return conv3d(gn(x, p, "norm_out.", g, True), p, "conv_out.")

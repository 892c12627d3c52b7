"""Weights of every configuration, made by the benchmark on the device from ``--seed``.

The leaves are named as the published model's state dict names them (the
port loads them by these names; the reference reads them by the same), so
both sides get the same numbers. Every leaf of two or more dimensions is
uniform in +-1/sqrt(fan_in) (fan_in: size(1) times the kernel, as torch
counts it, the transposed conv's OUT channels included), a conv or linear
bias likewise; GroupNorm scales 1 + U(+-0.1) and shifts U(+-0.1). So
``final_conv`` and every attention ``proj_out`` are nonzero and the
attention path is live. All leaves are views of one float32 buffer drawn
by one ``torch.rand`` call.
"""
from __future__ import annotations

import math

import torch

from . import traffic
from .reference.nets import parse_attention


def _gn(specs, pre, c):
    specs += [(pre + "weight", (c,), "gn_weight"), (pre + "bias", (c,), "gn_bias")]


def _lin(specs, pre, cout, cin, bias=True):
    specs.append((pre + "weight", (cout, cin), "weight"))
    if bias:
        specs.append((pre + "bias", (cout,), "bias"))


def _conv(specs, pre, cout, cin, k, dims, bias=True):
    specs.append((pre + "weight", (cout, cin) + (k,) * dims, "weight"))
    if bias:
        specs.append((pre + "bias", (cout,), "bias"))


def unet_specs(u: dict) -> list:
    """(name, shape, kind) of the UNet's leaves."""
    specs = []
    k = u["kernel_size"]
    feats = list(u["features"])
    heads = parse_attention(u["attention"], len(feats))
    t0 = u["time_embedding_dim"]
    tdim = 4 * t0
    _lin(specs, "time_mlp.0.", tdim, t0)
    _lin(specs, "time_mlp.2.", tdim, tdim)

    def double(pre, cin, mid, cout):
        _conv(specs, pre + "block1.conv.", mid, cin, k, 2, bias=False)
        _gn(specs, pre + "block1.norm.", mid)
        _lin(specs, pre + "time_mlp.1.", mid, tdim)
        _conv(specs, pre + "block2.conv.", cout, mid, k, 2, bias=False)
        _gn(specs, pre + "block2.norm.", cout)

    def attention(pre, c):
        _gn(specs, pre + "norm.", c)
        specs.append((pre + "mha.in_proj_weight", (3 * c, c), "weight"))
        specs.append((pre + "mha.in_proj_bias", (3 * c,), "bias"))
        _lin(specs, pre + "mha.out_proj.", c, c)
        _conv(specs, pre + "proj_out.", c, c, 1, 1)

    ch = u["in_channels"]
    for i, f in enumerate(feats):
        double(f"encoder.{i}.0.", ch, f, f)
        if heads[i] is not None:
            attention(f"encoder.{i}.1.", f)
        _gn(specs, f"encoder.{i}.2.norm.", f)
        ch = f
    double("bottleneck.", ch, 2 * ch, 2 * ch)
    ch = 2 * ch
    for i, f in enumerate(reversed(feats)):
        specs.append((f"decoder.{i}.0.conv.weight", (ch, f, 2, 2), "weight"))
        specs.append((f"decoder.{i}.0.conv.bias", (f,), "bias"))
        _gn(specs, f"decoder.{i}.0.norm.", f)
        double(f"decoder.{i}.1.", 2 * f, f, f)
        if heads[::-1][i] is not None:
            attention(f"decoder.{i}.2.", f)
        ch = f
    _conv(specs, "final_conv.", u["out_channels"], ch, k, 2)
    return specs


def _res(specs, pre, cin, cout, k):
    _gn(specs, pre + "norm1.", cin)
    _conv(specs, pre + "conv1.", cout, cin, k, 3)
    _gn(specs, pre + "norm2.", cout)
    _conv(specs, pre + "conv2.", cout, cout, k, 3)
    if cin != cout:
        _conv(specs, pre + "residual_layer.", cout, cin, 1, 3)


def encoder_specs(v: dict) -> list:
    f1, f2, f3 = v["features"]
    k, specs = v["kernel_size"], []
    _conv(specs, "conv_in.", f1, v["in_channels"], k, 3)
    _res(specs, "res1_1.", f1, f1, k)
    _res(specs, "res1_2.", f1, f1, k)
    _conv(specs, "down1.", f1, f1, k, 3)
    _res(specs, "res2_1.", f1, f2, k)
    _res(specs, "res2_2.", f2, f2, k)
    _conv(specs, "down2.", f2, f2, k, 3)
    _res(specs, "res3_1.", f2, f3, k)
    _res(specs, "res3_2.", f3, f3, k)
    _gn(specs, "norm_out.", f3)
    _conv(specs, "conv_out.", 2 * v["latent_channels"], f3, k, 3)
    return specs


def decoder_specs(v: dict) -> list:
    f1, f2, f3 = v["features"]
    k, specs = v["kernel_size"], []
    _conv(specs, "conv_in.", f3, v["latent_channels"], k, 3)
    _res(specs, "res1_1.", f3, f3, k)
    _res(specs, "res1_2.", f3, f3, k)
    _conv(specs, "conv_up1.", f2, f3, k, 3)
    _res(specs, "res2_1.", f2, f2, k)
    _res(specs, "res2_2.", f2, f2, k)
    _conv(specs, "conv_up2.", f1, f2, k, 3)
    _res(specs, "res3_1.", f1, f1, k)
    _res(specs, "res3_2.", f1, f1, k)
    _gn(specs, "norm_out.", f1)
    _conv(specs, "conv_out.", v["in_channels"], f1, k, 3)
    return specs


def model_specs(cfg: dict) -> list:
    """Every leaf a configuration's cell uses, prefixed as the port's state dict
    has it: the predictor's UNet, E2D and D3D; the stage-1 model's E3D and D3D."""
    pre = lambda p, specs: [(p + n, s, kd) for n, s, kd in specs]  # noqa: E731
    if cfg["model"] == "latent_diffusion_predictor":
        return (pre("model.", unet_specs(cfg["unet"]))
                + pre("vae.encoder_2d.", encoder_specs(cfg["vae"]))
                + pre("vae.decoder_3d.", decoder_specs(cfg["vae"])))
    if cfg["model"] == "vae_stage1":
        return (pre("encoder_3d.", encoder_specs(cfg["vae"]))
                + pre("decoder_3d.", decoder_specs(cfg["vae"])))
    raise ValueError(f"unknown model {cfg['model']!r}")


def make(cfg: dict, seed: int, device) -> dict:
    """{name: float32 tensor} of ``model_specs(cfg)``, from one uniform draw on ``device``."""
    specs = model_specs(cfg)
    scales, offsets, counts = [], [], []
    fan = {}
    for name, shape, kind in specs:
        if kind == "weight":
            receptive = math.prod(shape[2:])
            fan[name.rsplit(".", 1)[0]] = shape[1] * receptive
            scales.append(1.0 / math.sqrt(shape[1] * receptive))
            offsets.append(0.0)
        elif kind == "bias":
            f = fan.get(name.rsplit(".", 1)[0])
            if name.endswith("in_proj_bias"):
                f = shape[0] // 3
            scales.append(1.0 / math.sqrt(f))
            offsets.append(0.0)
        else:                                  # GroupNorm: 1 + U(+-0.1), U(+-0.1)
            scales.append(0.1)
            offsets.append(1.0 if kind == "gn_weight" else 0.0)
        counts.append(math.prod(shape))
    total = sum(counts)
    g = traffic.generator(seed, traffic.WEIGHTS, 0, device=device)
    u = torch.rand(total, generator=g, device=device)
    cnt = torch.as_tensor(counts, device=device)
    scale = torch.repeat_interleave(torch.as_tensor(scales, device=device), cnt, output_size=total)
    offset = torch.repeat_interleave(torch.as_tensor(offsets, device=device), cnt,
                                     output_size=total)
    values = torch.addcmul(offset, scale, u.mul_(2.0).sub_(1.0))
    return {name: t.view(shape) for (name, shape, _), t in zip(specs, values.split(counts))}


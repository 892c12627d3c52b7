"""Operations and bytes, from shapes: the yardstick of the MFU and roofline metrics.

Model FLOPs count the multiply-adds of convolutions, transposed
convolutions, linear maps and attention's two products (2 per
multiply-add), as ``torch.utils.flop_counter`` counts them; GroupNorm,
activations, pooling, the EDT and the samplers' elementwise updates are
left out. A training step is 3 forward passes (the backward as two),
whatever the program recomputes.

K1 (GroupNorm + activation) and K2 (self-attention) are read against their
roofline: the least time of a call, the larger of its operations over the
peak rate and its bytes over the HBM bandwidth. Their arithmetic is frozen
here from the port's device-time scripts: K1 reads x once and writes y
once and reads the float32 affine; K2 reads x and the four weights and
biases and writes y, and does the QKV, QK^T, PV and output products.
"""
from __future__ import annotations

import math

from .reference.nets import parse_attention

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}


def conv(n_out: int, cin: int, cout: int, kernel: int) -> int:
    """FLOPs of a convolution with ``n_out`` output positions (batch included)."""
    return 2 * n_out * cin * cout * kernel


def unet_eval(u: dict, n: int, h: int, w: int) -> int:
    """One UNet evaluation over n images of (in, h, w)."""
    k2 = u["kernel_size"] ** 2
    feats = list(u["features"])
    heads = parse_attention(u["attention"], len(feats))
    t0 = u["time_embedding_dim"]
    tdim = 4 * t0
    total = 2 * n * (t0 * tdim + tdim * tdim)

    def double(cin, mid, cout, px):
        return conv(px, cin, mid, k2) + conv(px, mid, cout, k2) + 2 * n * tdim * mid

    def attention(c, px):
        t = px // n
        return 2 * px * c * 3 * c + 2 * 2 * n * t * t * c + 2 * px * c * c + 2 * px * c * c

    ch, px = u["in_channels"], n * h * w
    for i, f in enumerate(feats):
        total += double(ch, f, f, px)
        if heads[i] is not None:
            total += attention(f, px)
        ch, px = f, px // 4
    total += double(ch, 2 * ch, 2 * ch, px)
    ch = 2 * ch
    for i, f in enumerate(reversed(feats)):
        total += 2 * px * ch * f * 4          # transposed 2x2 conv, per input position
        px *= 4
        total += double(2 * f, f, f, px)
        if heads[::-1][i] is not None:
            total += attention(f, px)
        ch = f
    return total + conv(px, ch, u["out_channels"], k2)


def _res(cin, cout, px, k3):
    return conv(px, cin, cout, k3) + conv(px, cout, cout, k3) + (
        conv(px, cin, cout, 1) if cin != cout else 0)


def encoder(v: dict, n: int, d: int, h: int, w: int) -> int:
    """An encoder pass over n volumes of (3, d, h, w)."""
    f1, f2, f3 = v["features"]
    k3 = v["kernel_size"] ** 3
    px = n * d * h * w
    total = conv(px, v["in_channels"], f1, k3) + _res(f1, f1, px, k3) * 2
    px //= 4
    total += conv(px, f1, f1, k3) + _res(f1, f2, px, k3) + _res(f2, f2, px, k3)
    px //= 4
    total += conv(px, f2, f2, k3) + _res(f2, f3, px, k3) + _res(f3, f3, px, k3)
    return total + conv(px, f3, 2 * v["latent_channels"], k3)


def decoder(v: dict, n: int, d: int, h: int, w: int) -> int:
    """A decoder pass from n latents of (latent, d, h / 4, w / 4) to (3, d, h, w)."""
    f1, f2, f3 = v["features"]
    k3 = v["kernel_size"] ** 3
    px = n * d * (h // 4) * (w // 4)
    total = conv(px, v["latent_channels"], f3, k3) + 2 * _res(f3, f3, px, k3)
    px *= 4
    total += conv(px, f3, f2, k3) + 2 * _res(f2, f2, px, k3)
    px *= 4
    total += conv(px, f2, f1, k3) + 2 * _res(f1, f1, px, k3)
    return total + conv(px, f1, v["in_channels"], k3)


def sampler_call(cfg: dict, b: int, evaluations: int) -> int:
    """Model FLOPs of one sampler call over b volumes: E2D, the UNet
    ``evaluations`` times over the b * S latent slices, D3D."""
    vol = cfg["volume"]
    s, h, w = vol["slices"], vol["height"], vol["width"]
    return (encoder(cfg["vae"], b, s, h, w) + decoder(cfg["vae"], b, s, h, w)
            + evaluations * unet_eval(cfg["unet"], b * s, h // 4, w // 4))


def evaluations(sampler: str, steps: int, num_timesteps: int) -> int:
    """UNet evaluations of a sampler call: DDIM one a step; DPM-Solver++ one a
    distinct timestep of the DDIM spacing."""
    if sampler == "ddim":
        return steps
    if sampler == "dpm":
        import numpy as np

        if steps == 1:
            return 1
        i = np.arange(steps)
        start, step = float(num_timesteps - 1), -float(num_timesteps - 1) / (steps - 1)
        vals = np.where(i < steps // 2, start + i * step, 0.0 - (steps - 1 - i) * step)
        return len(np.unique(vals.astype(np.int64)))
    raise ValueError(sampler)


def train_step(cfg: dict, b: int) -> int:
    """Model FLOPs of one stage-1 microbatch: 3 x (E3D + D3D) forward."""
    vol = cfg["volume"]
    s, h, w = vol["slices"], vol["height"], vol["width"]
    return 3 * (encoder(cfg["vae"], b, s, h, w) + decoder(cfg["vae"], b, s, h, w))


def k1_bytes(shape, elem_bytes: int) -> int:
    """K1 on x of ``shape`` (N, C, ...): x read once, y written once, the float32 affine."""
    return 2 * math.prod(shape) * elem_bytes + 2 * shape[1] * 4


def k1_bound_s(shape, elem_bytes: int) -> float:
    return k1_bytes(shape, elem_bytes) / HBM_BYTES_PER_S


def k2_flops(n: int, t: int, e: int) -> int:
    return 2 * n * t * e * 3 * e + 2 * 2 * n * t * t * e + 2 * n * t * e * e


def k2_bytes(n: int, t: int, e: int, elem_bytes: int) -> int:
    return elem_bytes * (2 * n * t * e + 4 * e * e + 4 * e)


def k2_bound_s(n: int, t: int, e: int, dtype: str) -> float:
    peak = PEAK_FLOPS["bfloat16" if dtype == "bfloat16" else "float32"]
    elem = 2 if dtype == "bfloat16" else 4
    return max(k2_flops(n, t, e) / peak, k2_bytes(n, t, e, elem) / HBM_BYTES_PER_S)

"""Plain reference of the latent-diffusion predictor's samplers.

img (B,S,1,H,W), velocity_2d (B,S,3,H,W), initial latents (B*S, C, H/4, W/4)
-> EDT of the mask (scipy), bilinear to the latent grid (``F.interpolate``)
-> E2D mu of the normalized 2D velocity -> DDIM (eta 0) or multistep
DPM-Solver++ (order 2, Lu et al. 2022, arXiv:2211.01095) over the UNet
-> D3D decode, denormalize, mask. The schedule is linear in beta over T
steps, x0 clipped to +-30, timesteps ``torch.linspace(T-1, 0, n).long()``
as the reference project takes them. Float32 throughout, TF32 off (or the
nets under bfloat16 autocast, to read the rounding of bf16); the VAE
runs a volume at a time and the UNet over all slices of a call at once.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from . import nets

CLIP = 30.0


@contextlib.contextmanager
def strict_float32(tf32_convs: bool = False):
    """Float32 matmuls with TF32 off, convs with TF32 only where ``tf32_convs``
    (restored on exit)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = tf32_convs
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def alphas_cumprod(cfg: dict) -> np.ndarray:
    betas = np.linspace(cfg["beta_start"], cfg["beta_end"], cfg["num_timesteps"], dtype=np.float64)
    return np.cumprod(1.0 - betas)


def timesteps(cfg: dict, n: int) -> list:
    return torch.linspace(cfg["num_timesteps"] - 1, 0, n).long().tolist()


def request_noise(seed: int, shape) -> torch.Tensor:
    """A served request's initial latents (S, C, H/4, W/4): normal draws of a
    CPU generator seeded with the request's seed."""
    return torch.randn(shape, generator=torch.Generator("cpu").manual_seed(int(seed)))


def edt(img: torch.Tensor) -> torch.Tensor:
    """Euclidean distance of each fluid pixel to the nearest fibre pixel,
    (N, H, W) -> float32, by scipy on the host."""
    a = img.detach().cpu().numpy()
    out = np.stack([ndimage.distance_transform_edt(m) for m in a]).astype(np.float32)
    return torch.from_numpy(out).to(img.device)


def conditioning(p: dict, cfg: dict, img, v2d):
    b, s, _, h, w = img.shape
    v = cfg["vae"]
    lh, lw = h // 4, w // 4
    out_scale = torch.tensor(cfg["normalizer"]["output"], device=img.device).view(1, 3, 1, 1, 1)
    z = []
    for i in range(b):  # a volume at a time
        mu, _ = nets.encoder(nets_prefix(p, "vae.encoder_2d."), v,
                             v2d[i:i + 1].transpose(1, 2) / out_scale)
        z.append(mu)
    z = torch.cat(z).transpose(1, 2).reshape(b * s, v["latent_channels"], lh, lw)
    m = img.reshape(b * s, h, w)
    if cfg["distance_transform"]:
        m = edt(m)
    m = m[:, None] / cfg["normalizer"]["input"][0]
    m = F.interpolate(m, size=(lh, lw), mode="bilinear", align_corners=False)
    return z, m


def nets_prefix(p: dict, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: t for k, t in p.items() if k.startswith(prefix)}


def _eps(punet, cfg, x, z, m, t):
    tt = torch.full((x.shape[0],), int(t), dtype=torch.int64, device=x.device)
    return nets.unet(punet, cfg["unet"], torch.cat([x, z, m], dim=1), tt)


def ddim(punet, cfg, x, z, m, n):
    ac = alphas_cumprod(cfg)
    ts = timesteps(cfg, n)
    for t, t_prev in zip(ts, ts[1:] + [-1]):
        eps = _eps(punet, cfg, x, z, m, t)
        a_t = float(ac[t])
        a_prev = float(ac[t_prev]) if t_prev >= 0 else 1.0
        x0 = ((x - np.sqrt(1.0 - a_t) * eps) / max(np.sqrt(a_t), 1e-8)).clamp(-CLIP, CLIP)
        x = np.sqrt(a_prev) * x0 + np.sqrt(1.0 - a_prev) * eps
    return x


def dpm(punet, cfg, x, z, m, n):
    """Multistep DPM-Solver++ in data prediction: in log-SNR lambda the step
    i -> i+1 is x <- (sigma_{i+1}/sigma_i) x - alpha_{i+1} expm1(-h_i) D_i, with
    D_i = x0_i + h_i/(2 h_{i-1}) (x0_i - x0_{i-1}) between the first and
    the last step, and a last node at alpha_bar = 1."""
    ac = alphas_cumprod(cfg).astype(np.float32).astype(np.float64)
    ts = sorted(set(timesteps(cfg, n)), reverse=True)
    alpha = [np.sqrt(ac[t]) for t in ts] + [1.0]
    sigma = [np.sqrt(1.0 - ac[t]) for t in ts] + [0.0]
    with np.errstate(divide="ignore"):
        lam = [np.log(a) - np.log(s) for a, s in zip(alpha, sigma)]
    prev = None
    for i, t in enumerate(ts):
        eps = _eps(punet, cfg, x, z, m, t)
        x0 = ((x - sigma[i] * eps) / max(alpha[i], 1e-8)).clamp(-CLIP, CLIP)
        h = lam[i + 1] - lam[i]
        d = x0
        if 0 < i < len(ts) - 1 and np.isfinite(h):
            h_prev = lam[i] - lam[i - 1]
            if h_prev > 0:
                d = x0 + (h / (2.0 * h_prev)) * (x0 - prev)
        x = (sigma[i + 1] / max(sigma[i], 1e-20)) * x - alpha[i + 1] * np.expm1(-h) * d
        prev = x0
    return x


def decode(p: dict, cfg: dict, x, img):
    b, s, _, h, w = img.shape
    v = cfg["vae"]
    out_scale = torch.tensor(cfg["normalizer"]["output"], device=img.device).view(1, 3, 1, 1, 1)
    lat = x.reshape(b, s, v["latent_channels"], h // 4, w // 4).transpose(1, 2)
    pd3d = nets_prefix(p, "vae.decoder_3d.")
    vel = torch.cat([nets.decoder(pd3d, v, lat[i:i + 1]) for i in range(b)]) * out_scale
    return vel.transpose(1, 2) * img


@torch.no_grad()
def predict(p: dict, cfg: dict, img, v2d, noise, sampler: str, steps: int,
            dtype=torch.float32) -> torch.Tensor:
    """The reference's (B,S,3,H,W) velocity for one sampler call; ``dtype``
    bfloat16 runs the nets under bfloat16 autocast (the sampler's own
    arithmetic stays float32)."""
    autocast = (torch.autocast(img.device.type, dtype=dtype) if dtype != torch.float32
                else contextlib.nullcontext())
    with strict_float32(), autocast:
        img, v2d, noise = img.float(), v2d.float(), noise.float()
        z, m = conditioning(p, cfg, img, v2d)
        z = z.float()
        punet = nets_prefix(p, "model.")
        loop = {"ddim": ddim, "dpm": dpm}[sampler]
        x = loop(punet, cfg, noise, z, m, steps)
        return decode(p, cfg, x, img).float()

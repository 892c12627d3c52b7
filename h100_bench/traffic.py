"""Inputs of every cell, made from ``--seed`` (the benchmark's one generator).

Each seed gets the same set of sizes in another order: fibre coverages come
from fixed quantiles of the configuration's range and the open loop's gaps
from fixed quantiles of the exponential distribution, both permuted by the
seed, so two seeds differ in placement and order and not in the amount of
work. Positions, radii, velocity fields and noise are drawn from
``torch.Generator`` streams keyed by (seed, purpose, index).

Microstructures are fibre discs extruded along z (1 = fluid, 0 = fibre).
The 2D velocity is a smooth in-plane field (vz = 0), masked by the fluid;
the 3D velocity of the training cell is a smooth field with all three
components, masked alike, at the scale of normalized data.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def seed_int(seed: int, *keys) -> int:
    """A 63-bit generator seed for ``seed`` and a purpose (``keys``)."""
    words = [int(seed) & 0xFFFFFFFFFFFFFFFF] + [int(k) for k in keys]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, *keys, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_int(seed, *keys))


def permutation(n: int, seed: int, *keys) -> np.ndarray:
    return np.random.default_rng(seed_int(seed, *keys)).permutation(n)


# purposes of the streams (the second key of seed_int)
POOL, NOISE, ARRIVALS, PICK, TRAIN_NOISE, WEIGHTS = 1, 2, 3, 4, 5, 6


def coverages(n: int, lo: float, hi: float, seed: int) -> np.ndarray:
    """``n`` Poisson coverages: the same quantiles of [lo, hi] for every seed, permuted."""
    q = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    return q[permutation(n, seed, POOL, 0)]


def fibre_masks(n: int, h: int, w: int, micro: dict, seed: int, device="cpu",
                chunk: int = 32) -> torch.Tensor:
    """``n`` cross-sections (n, h, w) float32, 1 = fluid. Volume i holds
    ``coverage_i * h * w / (pi r_mean^2)`` discs with radii uniform in the
    configured range, centres uniform over the plane."""
    r_lo, r_hi = micro["fibre_radius_px"]
    cov = coverages(n, *micro["fibre_coverage"], seed)
    r_mean2 = (r_lo ** 2 + r_lo * r_hi + r_hi ** 2) / 3.0  # E[r^2] of U(r_lo, r_hi)
    counts = np.maximum(1, np.round(cov * h * w / (math.pi * r_mean2))).astype(np.int64)
    k_max = int(counts.max())
    g = generator(seed, POOL, 1, device=device)
    cy = torch.rand((n, k_max), generator=g, device=device) * h
    cx = torch.rand((n, k_max), generator=g, device=device) * w
    r = r_lo + (r_hi - r_lo) * torch.rand((n, k_max), generator=g, device=device)
    counts_t = torch.as_tensor(counts, device=device)
    live = torch.arange(k_max, device=device)[None, :] < counts_t[:, None]
    r = torch.where(live, r, torch.full_like(r, -1.0))
    ys = torch.arange(h, device=device, dtype=torch.float32).view(1, 1, h, 1) + 0.5
    xs = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, 1, w) + 0.5
    solid = torch.zeros((n, h, w), dtype=torch.bool, device=device)
    for k in range(0, k_max, chunk):
        sl = slice(k, k + chunk)
        d2 = (ys - cy[:, sl, None, None]) ** 2 + (xs - cx[:, sl, None, None]) ** 2
        solid |= (d2 <= (r[:, sl, None, None] ** 2)).any(dim=1)
    return (~solid).float()


def smooth_field(n: int, c: int, d: int, h: int, w: int, g: torch.Generator, device,
                 cells: int = 16) -> torch.Tensor:
    """(n, c, d, h, w) float32, unit-variance noise on a coarse grid of
    ``cells`` squares a side (depth 3), interpolated trilinearly."""
    coarse = torch.randn((n, c, 3, cells, cells), generator=g, device=device)
    return F.interpolate(coarse, size=(d, h, w), mode="trilinear", align_corners=False)


def sampler_pool(cfg: dict, n: int, seed: int, device) -> tuple:
    """The pool of (img (n,S,1,H,W), v2d (n,S,3,H,W)) float32 volumes of the
    sampler cells: z-extruded fibres and a masked in-plane velocity."""
    vol = cfg["volume"]
    s, h, w = vol["slices"], vol["height"], vol["width"]
    mask = fibre_masks(n, h, w, cfg["microstructure"], seed, device)        # (n, h, w)
    img = mask[:, None, None].expand(n, s, 1, h, w).contiguous()
    g = generator(seed, POOL, 2, device=device)
    field = smooth_field(n, 2, s, h, w, g, device) * cfg["velocity_2d_scale"]  # (n, 2, s, h, w)
    v2d = torch.zeros((n, s, 3, h, w), device=device)
    v2d[:, :, :2] = field.transpose(1, 2)
    return img, v2d * img


def call_noise(cfg: dict, b: int, seed: int, call: int, device) -> torch.Tensor:
    """A sampler call's initial latents (b * ld, C, H/4, W/4)."""
    vol = cfg["volume"]
    shape = (b * vol["slices"], cfg["vae"]["latent_channels"], vol["height"] // 4,
             vol["width"] // 4)
    return torch.randn(shape, generator=generator(seed, NOISE, call, device=device), device=device)


def call_rows(pool_size: int, b: int, seed: int, call: int, device) -> torch.Tensor:
    """The pool rows of a call, on the device: ``b`` distinct rows, a fresh draw a call."""
    g = generator(seed, PICK, call, device=device)
    return torch.randperm(pool_size, generator=g, device=device)[:b]


def train_pool(cfg: dict, n: int, seed: int, device) -> dict:
    """``n`` normalized training volumes: 'velocity' (n, 3, D, H, W), masked,
    and 'microstructure' (n, 1, D, H, W)."""
    vol = cfg["volume"]
    s, h, w = vol["slices"], vol["height"], vol["width"]
    mask = fibre_masks(n, h, w, cfg["microstructure"], seed, device)
    micro = mask[:, None, None].expand(n, 1, s, h, w).contiguous()
    g = generator(seed, POOL, 3, device=device)
    vel = smooth_field(n, 3, s, h, w, g, device) * cfg["velocity_3d_scale"]
    return {"velocity": (vel * micro).contiguous(), "microstructure": micro}


def pool_order(n_pool: int, seed: int, device) -> torch.Tensor:
    """A seed-drawn order of the training pool, on the device: microbatch k
    takes its rows ``k * b`` on, so the first n_pool / b see rows that all differ."""
    g = generator(seed, PICK, 0, device=device)
    return torch.randperm(n_pool, generator=g, device=device)


def train_noise(cfg: dict, seed: int, step: int, device) -> torch.Tensor:
    """The reparameterization noise of microbatch ``step``: (B, latent, D, H/4, W/4)."""
    vol, tr = cfg["volume"], cfg["train"]
    shape = (tr["batch_size"], cfg["vae"]["latent_channels"], vol["slices"],
             vol["height"] // 4, vol["width"] // 4)
    return torch.randn(shape, generator=generator(seed, TRAIN_NOISE, step, device=device),
                       device=device)


def arrival_gaps(n: int, rate: float, seed: int) -> np.ndarray:
    """``n`` Poisson inter-arrival gaps (s) at ``rate``: the exponential
    distribution's quantiles at (i + 0.5) / n, the same for every seed,
    in a seed-drawn order."""
    q = (np.arange(n) + 0.5) / n
    return (-np.log1p(-q) / rate)[permutation(n, seed, ARRIVALS, 0)]

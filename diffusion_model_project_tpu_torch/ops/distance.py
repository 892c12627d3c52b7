"""Exact Euclidean distance transform on the device, in plain torch.

Counterpart of the JAX ``ops/distance.py``, with the same two-phase
separable decomposition and the same float32 arithmetic, so results agree
exactly:

  phase 1:  g[y, x]  = min_{y': im[y',x]=0} |y - y'|   (vectorised: the index
            of the nearest solid row above and below each pixel comes from a
            running max over rows, with no Python loop over rows)
  phase 2:  D[y, x]² = min_{x'} ( g[y, x']² + (x - x')² )  (brute force over
            x', in blocks of 64 output columns so the (N, H, block, W)
            intermediate stays bounded)

An all-fluid image (no zero pixel) returns the geometric bound hypot(H, W).
"""
from __future__ import annotations

import math

import torch

# columns with no solid pixel carry this sentinel (exact in float32)
_BIG = 1e9
# output columns per phase-2 step: bounds the (N, H, _BLOCK, W) intermediate
_BLOCK = 64


def _column_distance(solid: torch.Tensor) -> torch.Tensor:
    """Per-column 1D distance to the nearest solid pixel; solid: (N, H, W) bool."""
    h = solid.shape[1]
    rows = torch.arange(h, device=solid.device).view(1, h, 1)
    # nearest solid at or above each row: running max of solid row indices
    above = torch.where(solid, rows, torch.full_like(rows, -1)).cummax(dim=1).values
    # nearest solid at or below: the same on the row-flipped image
    below = torch.where(solid.flip(1), rows, torch.full_like(rows, -1)).cummax(dim=1).values
    below = (h - 1 - below).flip(1)
    big = torch.tensor(_BIG, dtype=torch.float32, device=solid.device)
    down = torch.where(above >= 0, (rows - above).float(), big)
    up = torch.where(below <= h - 1, (below - rows).float(), big)
    return torch.minimum(down, up)


def distance_transform_edt(img: torch.Tensor) -> torch.Tensor:
    """Exact EDT of a batch of binary images ``(N, H, W)`` (1=fluid, 0=solid).

    Returns float32 distances from each nonzero pixel to the nearest zero
    pixel (zero pixels map to 0).
    """
    n, h, w = img.shape
    g = _column_distance(img == 0)
    g2 = g * g
    xs = torch.arange(w, dtype=torch.float32, device=img.device)
    block = _BLOCK if w % _BLOCK == 0 else w
    out = []
    for xc in xs.split(block):
        d2 = g2[:, :, None, :] + torch.square(xc[:, None] - xs[None, :])
        out.append(d2.amin(dim=-1))  # (N, H, block)
    d2 = torch.cat(out, dim=-1)
    return torch.clamp(torch.sqrt(d2), max=float(math.hypot(h, w)))

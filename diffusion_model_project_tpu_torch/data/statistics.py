"""Train-set statistics generation (the port's own copy of the JAX package's
``data/statistics.py``, after the reference shared/generate_statistics.py).

Computes statistics.json FROM TRAINING INDICES ONLY to avoid leakage:
global max/mean/std/min + per-component max / fluid-masked mean / std / min /
percentiles(1,5,50,95,99) / median / MAD for U and U_2d, plus p and dxyz,
with a metadata block. Pure numpy (torch only deserializes the .pt files).
"""
from __future__ import annotations

import json
import os
import os.path as osp
from datetime import datetime
from typing import Dict, List, Optional

import numpy as np

from .dataset import _load_pt

_PERCENTILES = [1, 5, 50, 95, 99]


def compute_velocity_statistics(
    velocity: np.ndarray,
    mask: Optional[np.ndarray] = None,
    prefix: str = "U",
) -> Dict:
    """velocity (N, slices, 3, H, W) or (N, 3, H, W); mask (N, slices, 1, H, W)."""
    stats: Dict = {}
    is_3d = velocity.ndim == 5
    masked = velocity * np.broadcast_to(mask, velocity.shape) if mask is not None else velocity

    stats[prefix] = {
        "max": float(np.abs(masked).max()),
        "mean": float(masked.mean()),
        "std": float(masked.std(ddof=1)),
        "min": float(masked.min()),
    }

    pc: Dict = {}
    for c_idx, c_name in enumerate("uvw"[: velocity.shape[2 if is_3d else 1]]):
        component = velocity[:, :, c_idx] if is_3d else velocity[:, c_idx]
        pc[f"max_{c_name}"] = float(np.abs(component).max())
        if mask is not None:
            mask_comp = mask[:, :, 0] if is_3d else mask[:, 0]
            comp_masked = component * mask_comp
            pc[f"mean_{c_name}"] = float(np.abs(comp_masked).sum() / mask_comp.sum())
            vals = comp_masked[mask_comp > 0.5]
            pc[f"std_{c_name}"] = float(vals.std(ddof=1)) if len(vals) else 0.0
        else:
            pc[f"mean_{c_name}"] = float(np.abs(component).mean())
            pc[f"std_{c_name}"] = float(component.std(ddof=1))
        pc[f"min_{c_name}"] = float(component.min())
        flat = component.reshape(-1)
        # one selection pass for all percentiles (the flattened array is tens
        # of millions of elements at real-dataset scale; per-percentile calls
        # re-partition it each time). np.median == np.percentile(·, 50) with
        # the default interpolation, so p50 doubles as the median.
        pvals = np.percentile(flat, _PERCENTILES)
        for p, v in zip(_PERCENTILES, pvals):
            pc[f"p{p}_{c_name}"] = float(v)
        median = (float(pvals[_PERCENTILES.index(50)]) if 50 in _PERCENTILES
                  else float(np.median(flat)))
        pc[f"median_{c_name}"] = median
        pc[f"mad_{c_name}"] = float(np.median(np.abs(flat - median)))
    stats[f"{prefix}_per_component"] = pc
    return stats


def compute_statistics_from_dataset(
    dataset_dir: str,
    train_indices: List[int],
    use_3d: bool = True,
) -> Dict:
    """Compute statistics from the training subset of <dataset_dir>/x/*.pt."""
    x = osp.join(dataset_dir, "x")
    idx = np.asarray(train_indices)
    stats: Dict = {}

    domain_path = osp.join(x, "domain.pt")
    domain_train = _load_pt(domain_path)[idx] if osp.exists(domain_path) else None

    for prefix, fname in (("U", "U.pt"), ("U_2d", "U_2d.pt")):
        path = osp.join(x, fname)
        if osp.exists(path):
            vel = _load_pt(path)[idx]
            stats.update(compute_velocity_statistics(vel, mask=domain_train, prefix=prefix))

    p_path = osp.join(x, "p.pt")
    if osp.exists(p_path):
        p = _load_pt(p_path)[idx]
        stats["p"] = {"max": float(np.abs(p).max()), "mean": float(p.mean()),
                      "std": float(p.std(ddof=1))}
    dxyz_path = osp.join(x, "dxyz.pt")
    if osp.exists(dxyz_path):
        d = _load_pt(dxyz_path)[idx]
        stats["dxyz"] = {"max": float(np.abs(d).max()), "mean": float(d.mean())}
    return stats


def generate_statistics(
    dataset_dir: str,
    output: str = "statistics.json",
    split_file: str = "splits.json",
    generate_split: bool = False,
    seed: int = 2024,
    train_ratio: float = 0.70,
    val_ratio: float = 0.15,
    force: bool = False,
) -> Dict:
    """The CLI's work: get/create the split, compute train-only stats, write."""
    from .split import create_split, load_split, save_split

    out_path = osp.join(dataset_dir, output)
    if osp.exists(out_path) and not force:
        print(f"{out_path} exists; use force=True/--force to overwrite")
        with open(out_path) as f:
            return json.load(f)

    split_path = osp.join(dataset_dir, split_file)
    if generate_split or not osp.exists(split_path):
        num_samples = _load_pt(osp.join(dataset_dir, "x", "domain.pt")).shape[0]
        split = create_split(num_samples, train_ratio, val_ratio,
                             1.0 - train_ratio - val_ratio, seed)
        save_split(split, split_path)
    else:
        split = load_split(split_path)

    stats = compute_statistics_from_dataset(dataset_dir, split["train"])
    stats["metadata"] = {
        "generated": datetime.now().isoformat(),
        "num_train_samples": len(split["train"]),
        "split_seed": split.get("metadata", {}).get("seed", seed),
        "split_file": split_file,
        "note": "Statistics computed from TRAINING indices only (no leakage)",
    }
    with open(out_path, "w") as f:
        json.dump(stats, f, indent=2)
    print(f"Saved statistics to {out_path}")
    return stats

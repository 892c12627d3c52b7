"""End-to-end evaluation metric library (the port's own copy of the JAX
package's ``losses/eval_metrics.py``; numpy only).

The reference's scripts/eval_testset_end2end.py:78-424: fluid-masked
per-component MAE/MSE/RMSE, normalized variants dividing by the
per-component max from statistics.json, voxelwise cosine similarity, IoU of
top-k% magnitude voxels, and accuracy = 1/(1+nMAE_total).

All functions take numpy arrays (or CPU tensors) shaped (batch, slices, 3, H,
W) with an optional (batch, slices, 1, H, W) mask and return python floats.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def _ensure_5d(*arrays):
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
        else:
            a = np.asarray(a)
            out.append(a[None] if a.ndim == 4 else a)
    return out


def compute_mae_per_component(y_pred, y_true, mask=None) -> Tuple[float, float, float]:
    y_pred, y_true, mask = _ensure_5d(y_pred, y_true, mask)
    err = np.abs(y_pred - y_true)
    if mask is not None:
        m = np.broadcast_to(mask, err.shape)
        if m.sum() > 0:
            return tuple(
                float((err[:, :, c] * m[:, :, c]).sum() / (m[:, :, c].sum() + 1e-8))
                for c in range(3))
        return (0.0, 0.0, 0.0)
    return tuple(float(err[:, :, c].mean()) for c in range(3))


def compute_mse_per_component(y_pred, y_true, mask=None) -> Tuple[float, float, float]:
    y_pred, y_true, mask = _ensure_5d(y_pred, y_true, mask)
    err_sq = np.square(y_pred - y_true)
    if mask is not None:
        m = np.broadcast_to(mask, err_sq.shape)
        return tuple(
            float((err_sq[:, :, c] * m[:, :, c]).sum() / (m[:, :, c].sum() + 1e-8))
            for c in range(3))
    return tuple(float(err_sq[:, :, c].mean()) for c in range(3))


def compute_rmse_per_component(y_pred, y_true, mask=None):
    mse = compute_mse_per_component(y_pred, y_true, mask)
    return tuple(float(np.sqrt(v)) for v in mse)


def compute_normalized_mae(y_pred, y_true, norm_factors, mask=None):
    mae_u, mae_v, mae_w = compute_mae_per_component(y_pred, y_true, mask)
    nmae_u = mae_u / (norm_factors[0] + 1e-8)
    nmae_v = mae_v / (norm_factors[1] + 1e-8)
    nmae_w = mae_w / (norm_factors[2] + 1e-8)
    return nmae_u, nmae_v, nmae_w, (nmae_u + nmae_v + nmae_w) / 3.0


def compute_normalized_mse(y_pred, y_true, norm_factors, mask=None):
    mse_u, mse_v, mse_w = compute_mse_per_component(y_pred, y_true, mask)
    nmse_u = mse_u / (norm_factors[0] ** 2 + 1e-8)
    nmse_v = mse_v / (norm_factors[1] ** 2 + 1e-8)
    nmse_w = mse_w / (norm_factors[2] ** 2 + 1e-8)
    return nmse_u, nmse_v, nmse_w, (nmse_u + nmse_v + nmse_w) / 3.0


def compute_cosine_similarity(y_pred, y_true, mask=None) -> float:
    y_pred, y_true, mask = _ensure_5d(y_pred, y_true, mask)
    c = y_pred.shape[2]
    p = np.moveaxis(y_pred, 2, -1).reshape(-1, c)
    t = np.moveaxis(y_true, 2, -1).reshape(-1, c)
    dot = (p * t).sum(axis=1)
    denom = np.linalg.norm(p, axis=1) * np.linalg.norm(t, axis=1) + 1e-8
    cos_sim = dot / denom
    if mask is not None:
        m = mask[:, :, 0].reshape(-1)
        n = m.sum()
        return float((cos_sim * m).sum() / n) if n > 0 else 0.0
    return float(cos_sim.mean())


def compute_iou_topk(y_pred, y_true, k_percent: float = 10.0, mask=None) -> float:
    """IoU of high-magnitude voxel sets, kept BUG-FOR-BUG with the reference
    (eval_testset_end2end.py:295-330): the threshold index is n*(100-k)/100
    into the DESCENDING sort, so "iou_top10" actually compares the top 90%
    sets (near-saturated for any sane prediction), not the top 10%. Faithful
    on purpose — eval reports must be comparable number-for-number with
    reference-produced ones."""
    y_pred, y_true, mask = _ensure_5d(y_pred, y_true, mask)
    mag_pred = np.linalg.norm(y_pred, axis=2).reshape(-1)
    mag_true = np.linalg.norm(y_true, axis=2).reshape(-1)
    if mask is not None:
        valid = mask[:, :, 0].reshape(-1) > 0.5
        mag_pred = mag_pred[valid]
        mag_true = mag_true[valid]
    if len(mag_pred) == 0:
        return 0.0
    k_idx = int(len(mag_pred) * (100 - k_percent) / 100)
    k_idx = min(k_idx, len(mag_pred) - 1)
    thr_pred = np.sort(mag_pred)[::-1][k_idx]
    thr_true = np.sort(mag_true)[::-1][k_idx]
    topk_pred = mag_pred >= thr_pred
    topk_true = mag_true >= thr_true
    inter = np.logical_and(topk_pred, topk_true).sum()
    union = np.logical_or(topk_pred, topk_true).sum()
    return float(inter / (union + 1e-8))


def compute_sanity_stats(tensor, name: str = "tensor") -> Dict[str, float]:
    tensor = np.asarray(tensor)
    return {
        f"{name}_min": float(tensor.min()),
        f"{name}_max": float(tensor.max()),
        f"{name}_mean": float(tensor.mean()),
        f"{name}_std": float(tensor.std(ddof=1)),
    }


def compute_all_metrics(
    y_pred, y_true, norm_factors, mask=None, compute_optional: bool = True
) -> Dict[str, float]:
    metrics: Dict[str, float] = {}
    mae_u, mae_v, mae_w = compute_mae_per_component(y_pred, y_true, mask)
    metrics.update(mae_u=mae_u, mae_v=mae_v, mae_w=mae_w,
                   mae_total=(mae_u + mae_v + mae_w) / 3.0)
    mse_u, mse_v, mse_w = compute_mse_per_component(y_pred, y_true, mask)
    metrics.update(mse_u=mse_u, mse_v=mse_v, mse_w=mse_w,
                   mse_total=(mse_u + mse_v + mse_w) / 3.0)
    metrics.update(rmse_u=float(np.sqrt(mse_u)), rmse_v=float(np.sqrt(mse_v)),
                   rmse_w=float(np.sqrt(mse_w)),
                   rmse_total=float(np.sqrt(metrics["mse_total"])))
    nmae_u, nmae_v, nmae_w, nmae_total = compute_normalized_mae(
        y_pred, y_true, norm_factors, mask)
    metrics.update(nmae_u=nmae_u, nmae_v=nmae_v, nmae_w=nmae_w, nmae_total=nmae_total)
    nmse_u, nmse_v, nmse_w, nmse_total = compute_normalized_mse(
        y_pred, y_true, norm_factors, mask)
    metrics.update(nmse_u=nmse_u, nmse_v=nmse_v, nmse_w=nmse_w, nmse_total=nmse_total)
    if compute_optional:
        metrics["cosine_similarity"] = compute_cosine_similarity(y_pred, y_true, mask)
        metrics["iou_top10"] = compute_iou_topk(y_pred, y_true, 10.0, mask)
        metrics["iou_top5"] = compute_iou_topk(y_pred, y_true, 5.0, mask)
    return metrics


def compute_accuracy_score(nmae_total: float) -> float:
    """Accuracy = 1/(1+nMAE_total), bounded in (0, 1]."""
    return 1.0 / (1.0 + nmae_total)

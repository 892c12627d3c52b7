"""Loss zoo for diffusion (noise-space) and VAE training, on torch tensors
(counterpart of the JAX ``losses/metrics.py``).

Numerical contracts of the reference loss definitions:
  - Diffusion_model/src/unet/metrics.py (mse/mae/huber, per-component and
    normalized variants with eps=1e-8, matrix-norm normalized_mse_loss,
    unmasked divergence_loss by central differences, one-sided at the edges)
  - VAE_model/utils/metrics.py (masked per-channel variants, mean-form KL)
  - VAE_model/src/dual_vae/model.py:380-382 (sum-form KL)

All tensors are channels-first (B, C, *spatial). ``cost_function`` is an
explicit registry (the reference resolves loss names with ``eval``).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..models.vae import kl_divergence_sum  # noqa: F401  (the sum-form KL lives with the VAE)


def _spatial_dims(x: torch.Tensor) -> tuple:
    if x.ndim == 4:
        return (-2, -1)
    if x.ndim == 5:
        return (-3, -2, -1)
    raise ValueError(f"Expected 4D or 5D tensor, got {x.ndim}D")


def _reduce(loss: torch.Tensor, reduce: bool) -> torch.Tensor:
    return loss.mean() if reduce else loss


def mse_loss(output, target, reduce=True):
    return _reduce(torch.mean(torch.square(output - target), dim=(-3, -2, -1)), reduce)


def mae_loss(output, target, reduce=True):
    return _reduce(torch.mean(torch.abs(output - target), dim=(-3, -2, -1)), reduce)


def huber_loss(output, target, reduce=True, delta=1.0):
    abs_err = torch.abs(output - target)
    quad = torch.clamp(abs_err, max=delta)
    loss_elem = 0.5 * quad * quad + delta * (abs_err - quad)
    return _reduce(torch.mean(loss_elem, dim=(-3, -2, -1)), reduce)


def normalized_mae_loss(output, target, reduce=True, eps=1e-8):
    """Sample-wise MAE / mean |target| (eps variant: VAE_model/utils/metrics.py:4-37)."""
    dims = (-3, -2, -1)
    mae = torch.mean(torch.abs(output - target), dim=dims)
    weight = torch.mean(torch.abs(target), dim=dims)
    return _reduce(mae / (weight + eps), reduce)


def _per_channel_weighted(loss_per_channel, weight_per_channel, reduce):
    if weight_per_channel is not None:
        w = torch.as_tensor(weight_per_channel, dtype=loss_per_channel.dtype,
                            device=loss_per_channel.device)
        if w.ndim == 1:
            w = w[None, :]
        loss_per_channel = loss_per_channel * w / w.sum()
    return _reduce(torch.mean(loss_per_channel, dim=-1), reduce)


def mae_loss_per_component(output, target, reduce=True, weight_per_channel=None):
    lpc = torch.mean(torch.abs(output - target), dim=_spatial_dims(output))
    return _per_channel_weighted(lpc, weight_per_channel, reduce)


def mse_loss_per_component(output, target, reduce=True, weight_per_channel=None):
    lpc = torch.mean(torch.square(output - target), dim=_spatial_dims(output))
    return _per_channel_weighted(lpc, weight_per_channel, reduce)


def normalized_mae_loss_per_component(output, target, reduce=True, weight_per_channel=None,
                                      eps=1e-8):
    dims = _spatial_dims(output)
    mae = torch.mean(torch.abs(output - target), dim=dims)
    norm = torch.mean(torch.abs(target), dim=dims)
    return _per_channel_weighted(mae / (norm + eps), weight_per_channel, reduce)


def normalized_mse_loss_per_component(output, target, reduce=True, weight_per_channel=None,
                                      eps=1e-8):
    dims = _spatial_dims(output)
    mse = torch.mean(torch.square(output - target), dim=dims)
    norm = torch.mean(torch.square(target), dim=dims)
    return _per_channel_weighted(mse / (norm + eps), weight_per_channel, reduce)


def normalized_mse_loss(output, target):
    """Frobenius-norm-squared ratio per (sample, channel), averaged
    (reference unet/metrics.py:405-437)."""
    diff_norm = torch.sum(torch.square(target - output), dim=(-2, -1))
    target_norm = torch.sum(torch.square(target), dim=(-2, -1))
    return torch.mean(diff_norm / (target_norm + 1e-8))


def divergence_loss(flow_field):
    """Unmasked divergence of (B, 3, D, H, W): ``torch.gradient``'s central
    differences inside, one-sided differences at the edges (numpy's and
    ``jnp.gradient``'s defaults) (reference unet/metrics.py:447-481)."""
    if flow_field.ndim != 5 or flow_field.shape[1] != 3:
        raise ValueError(f"divergence_loss takes (B, 3, D, H, W), got {tuple(flow_field.shape)}")
    u, v, w = flow_field[:, 0], flow_field[:, 1], flow_field[:, 2]
    du_dx = torch.gradient(u, dim=-1)[0]
    dv_dy = torch.gradient(v, dim=-2)[0]
    dw_dz = torch.gradient(w, dim=-3)[0]
    return torch.mean(torch.square(du_dx + dv_dy + dw_dz))


# --------------------------------------------------------------------------
# VAE losses (masked per-channel variants)
# --------------------------------------------------------------------------

def _mask_both(output, target, mask):
    if mask is not None:
        output = output * mask
        target = target * mask
    return output, target


def mae_loss_per_channel(output, target, mask=None, weight_per_channel=None, reduce=True):
    output, target = _mask_both(output, target, mask)
    lpc = torch.mean(torch.abs(output - target), dim=_spatial_dims(output))
    return _per_channel_weighted(lpc, weight_per_channel, reduce)


def normalized_mae_loss_per_channel(output, target, mask=None, reduce=True, eps=1e-8):
    output, target = _mask_both(output, target, mask)
    dims = _spatial_dims(output)
    mae = torch.mean(torch.abs(output - target), dim=dims)
    norm = torch.mean(torch.abs(target), dim=dims)
    return _reduce(torch.mean(mae / (norm + eps), dim=-1), reduce)


def normalized_mse_per_channel(output, target, mask=None, reduce=True, eps=1e-8):
    output, target = _mask_both(output, target, mask)
    dims = _spatial_dims(output)
    mse = torch.mean(torch.square(output - target), dim=dims)
    norm = torch.mean(torch.square(target), dim=dims)
    return _reduce(torch.mean(mse / (norm + eps), dim=-1), reduce)


def kl_divergence(mu, *, logvar=None, sigma=None):
    """Mean-form KL used by the VAE trainers (VAE_model/utils/metrics.py:231-250);
    the sigma variant uses the sum form."""
    if logvar is not None:
        return -0.5 * torch.mean(1 + logvar - torch.square(mu) - torch.exp(logvar))
    if sigma is not None:
        return -0.5 * torch.sum(1 + torch.log(torch.square(sigma)) - torch.square(mu)
                                - torch.square(sigma))
    raise ValueError("Provide logvar or sigma")


_REGISTRY: Dict[str, Callable] = {
    "mse_loss": mse_loss,
    "mae_loss": mae_loss,
    "huber_loss": huber_loss,
    "normalized_mae_loss": normalized_mae_loss,
    "normalized_mse_loss": normalized_mse_loss,
    "divergence_loss": divergence_loss,
    "mae_loss_per_component": mae_loss_per_component,
    "mse_loss_per_component": mse_loss_per_component,
    "normalized_mae_loss_per_component": normalized_mae_loss_per_component,
    "normalized_mse_loss_per_component": normalized_mse_loss_per_component,
    "mae_loss_per_channel": mae_loss_per_channel,
    "normalized_mae_loss_per_channel": normalized_mae_loss_per_channel,
    "normalized_mse_per_channel": normalized_mse_per_channel,
}


def cost_function(name: str) -> Callable:
    """Explicit loss registry (the reference uses eval(); unet/metrics.py:38-53)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"Unknown cost function {name!r}. Known: {sorted(_REGISTRY)}") from None

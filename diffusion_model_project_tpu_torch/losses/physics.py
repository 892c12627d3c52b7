"""Physics-informed losses and metrics for fluid-flow prediction.

Counterpart of the JAX ``losses/physics.py`` (reference
Diffusion_model/src/physics.py):
  - masked divergence (central differences, interior crop; physics.py:138-190)
  - flow-rate consistency (variance of area-normalized Q(x); physics.py:193-249)
  - no-slip penalty (physics.py:252-282; defined but unused by the trainer)
  - gradient / Laplacian smoothness, optionally velocity-magnitude-normalized
    (physics.py:285-422)
  - compute_physics_metrics: 7 diagnostic families (physics.py:425-599), as
    0-d tensors (no host sync)
  - reconstruct_velocity_from_noise_pred: x0_hat from eps_hat -> frozen D3D
    decode -> denormalize -> depth resize -> mask; gradients flow through the
    decoder to eps_hat, each residual block rematerialized
    (physics.py:602-673)
  - component_weighted_velocity_loss, compute_per_component_metrics
    (physics.py:676-803).

Velocities are channels-first: (B, 3, D, H, W) for the loss terms,
(B, S, 3, H, W) with masks (B, S, 1, H, W) for ``PhysicsLoss``, the metrics
and the component losses.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..ops.resize import interpolate_trilinear


def divergence_loss_masked(velocity, mask, eps=1e-8):
    """velocity (B,3,D,H,W), mask (B,1,D,H,W) -> scalar."""
    if velocity.ndim != 5 or velocity.shape[1] != 3:
        raise ValueError(f"velocity must be (B, 3, D, H, W), got {tuple(velocity.shape)}")
    u, v, w = velocity[:, 0:1], velocity[:, 1:2], velocity[:, 2:3]
    du_dx = ((u[..., 2:] - u[..., :-2]) / 2.0)[:, :, 1:-1, 1:-1, :]
    dv_dy = ((v[..., 2:, :] - v[..., :-2, :]) / 2.0)[:, :, 1:-1, :, 1:-1]
    dw_dz = ((w[:, :, 2:] - w[:, :, :-2]) / 2.0)[:, :, :, 1:-1, 1:-1]
    mask_interior = mask[:, :, 1:-1, 1:-1, 1:-1]
    divergence = (du_dx + dv_dy + dw_dz) * mask_interior
    return torch.sum(torch.square(divergence)) / (torch.sum(mask_interior) + eps)


def flow_rate_consistency_loss(velocity, mask, eps=1e-8):
    u_masked = velocity[:, 0:1] * mask
    q = torch.sum(u_masked, dim=(2, 3))            # (B, 1, W)
    fluid_area = torch.sum(mask, dim=(2, 3)) + eps  # (B, 1, W)
    q_norm = q / fluid_area
    q_mean = torch.mean(q_norm, dim=-1, keepdim=True)
    q_var = torch.mean(torch.square(q_norm - q_mean), dim=-1)
    rel_var = q_var / (torch.square(q_mean[..., 0]) + eps)
    return torch.mean(rel_var)


def no_slip_loss(velocity, mask, eps=1e-8):
    solid = 1.0 - mask
    vel_solid = velocity * solid
    return torch.sum(torch.square(vel_solid)) / (torch.sum(solid) + eps) / 3.0


def _pairwise_grad_sq(velocity, mask):
    """Sum of squared forward differences over fluid-fluid pairs + pair count."""
    total = 0.0
    count = 0.0
    for dim in (-1, -2, -3):
        n = velocity.shape[dim]
        grad = velocity.narrow(dim, 1, n - 1) - velocity.narrow(dim, 0, n - 1)
        m = mask.narrow(dim, 1, n - 1) * mask.narrow(dim, 0, n - 1)
        total = total + torch.sum(torch.square(grad) * m)
        count = count + 3.0 * torch.sum(m)  # 3 velocity channels share the mask
    return total, count


def _velocity_scale(velocity, mask, eps):
    return torch.sum(torch.square(velocity * mask)) / (torch.sum(mask) * 3 + eps)


def smoothness_loss(velocity, mask, eps=1e-8, normalize=True):
    total, count = _pairwise_grad_sq(velocity, mask)
    loss = total / (count + eps)
    if normalize:
        loss = loss / (_velocity_scale(velocity, mask, eps) + eps)
    return loss


def _laplacian_sq(velocity, mask):
    d2x = velocity[..., 2:] - 2 * velocity[..., 1:-1] + velocity[..., :-2]
    d2y = velocity[..., 2:, :] - 2 * velocity[..., 1:-1, :] + velocity[..., :-2, :]
    d2z = velocity[:, :, 2:] - 2 * velocity[:, :, 1:-1] + velocity[:, :, :-2]
    lap = d2x[:, :, 1:-1, 1:-1, :] + d2y[:, :, 1:-1, :, 1:-1] + d2z[:, :, :, 1:-1, 1:-1]
    mask_valid = (
        mask[:, :, 1:-1, 1:-1, :-2] * mask[:, :, 1:-1, 1:-1, 1:-1] * mask[:, :, 1:-1, 1:-1, 2:]
        * mask[:, :, 1:-1, :-2, 1:-1] * mask[:, :, 1:-1, 2:, 1:-1]
        * mask[:, :, :-2, 1:-1, 1:-1] * mask[:, :, 2:, 1:-1, 1:-1]
    )
    lap_sq = torch.sum(torch.square(lap * mask_valid))
    count = 3.0 * torch.sum(mask_valid)  # 3 velocity channels
    return lap_sq, count


def laplacian_smoothness_loss(velocity, mask, eps=1e-8, normalize=True):
    lap_sq, count = _laplacian_sq(velocity, mask)
    loss = lap_sq / (count + eps)
    if normalize:
        loss = loss / (_velocity_scale(velocity, mask, eps) + eps)
    return loss


@dataclasses.dataclass(frozen=True)
class PhysicsLoss:
    """Weighted sum of physics constraints (reference physics.py:45-135).

    ``__call__`` takes velocity (B, S, 3, H, W) and mask (B, S, 1, H, W) and
    returns (total, components): only the terms whose lambda is > 0 are
    computed, the components detached.
    """

    lambda_div: float = 0.0
    lambda_flow: float = 0.0
    lambda_smooth: float = 0.0
    lambda_laplacian: float = 0.0
    eps: float = 1e-8
    normalize_smoothness: bool = True

    def is_active(self) -> bool:
        return any(lam > 0 for lam in (self.lambda_div, self.lambda_flow,
                                       self.lambda_smooth, self.lambda_laplacian))

    def __call__(self, velocity, mask, return_components: bool = True):
        vel = velocity.transpose(1, 2)  # (B, 3, S, H, W)
        m = mask.transpose(1, 2)
        terms = (
            ("divergence", self.lambda_div, lambda: divergence_loss_masked(vel, m, self.eps)),
            ("flow_rate", self.lambda_flow, lambda: flow_rate_consistency_loss(vel, m, self.eps)),
            ("smoothness", self.lambda_smooth,
             lambda: smoothness_loss(vel, m, self.eps, self.normalize_smoothness)),
            ("laplacian", self.lambda_laplacian,
             lambda: laplacian_smoothness_loss(vel, m, self.eps, self.normalize_smoothness)),
        )
        components = {}
        total = velocity.new_zeros((), dtype=torch.float32)
        for name, lam, term in terms:
            if lam > 0:
                value = term()
                total = total + lam * value
                components[name] = value.detach()
        if return_components:
            return total, components
        return total


def compute_physics_metrics(velocity, mask, eps=1e-8) -> Dict[str, torch.Tensor]:
    """Diagnostic metrics (reference physics.py:425-599), each a 0-d tensor."""
    if velocity.ndim == 5 and velocity.shape[2] == 3:
        vel = velocity.transpose(1, 2)
        m = mask.transpose(1, 2) if mask.shape[2] == 1 else mask
    else:
        vel, m = velocity, mask
    m = m.float()
    metrics: Dict[str, torch.Tensor] = {}

    u, v, w = vel[:, 0:1], vel[:, 1:2], vel[:, 2:3]
    du_dx = ((u[..., 2:] - u[..., :-2]) / 2.0)[:, :, 1:-1, 1:-1, :]
    dv_dy = ((v[..., 2:, :] - v[..., :-2, :]) / 2.0)[:, :, 1:-1, :, 1:-1]
    dw_dz = ((w[:, :, 2:] - w[:, :, :-2]) / 2.0)[:, :, :, 1:-1, 1:-1]
    m_int = m[:, :, 1:-1, 1:-1, 1:-1]
    div = (du_dx + dv_dy + dw_dz) * m_int
    n_int = torch.sum(m_int) + eps
    metrics["div_mean"] = torch.sum(torch.abs(div)) / n_int
    # fluid-masked std of divergence
    mean_div = torch.sum(div) / n_int
    metrics["div_std"] = torch.sqrt(
        torch.sum(torch.square(div - mean_div) * m_int)
        / torch.clamp(torch.sum(m_int) - 1, min=1))

    q = torch.sum(u * m, dim=(2, 3))[:, 0]          # (B, W)
    area = torch.sum(m, dim=(2, 3))[:, 0] + eps
    q_norm = q / area
    q_mean = torch.mean(q_norm, dim=-1, keepdim=True)
    q_mean_abs = torch.mean(torch.abs(q_mean))
    q_std = torch.sqrt(torch.mean(torch.square(q_norm - q_mean)))
    metrics["flow_rate_cv"] = torch.where(q_mean_abs > 1e-6, q_std / (q_mean_abs + eps),
                                          torch.zeros_like(q_std))

    solid = 1.0 - m
    metrics["vel_in_solid"] = (torch.sqrt(torch.sum(torch.square(vel * solid)))
                               / torch.sqrt(torch.sum(solid) + eps))

    vel_mag = torch.sqrt(torch.sum(torch.square(vel), dim=1, keepdim=True))
    metrics["vel_mean_fluid"] = torch.sum(vel_mag * m) / (torch.sum(m) + eps)

    total, count = _pairwise_grad_sq(vel, m)
    metrics["gradient_smooth"] = total / (count + eps)
    lap_sq, lcount = _laplacian_sq(vel, m)
    metrics["laplacian_smooth"] = lap_sq / (lcount + eps)

    n_fluid = torch.sum(m) + eps
    for c, name in enumerate(["vel_u", "vel_v", "vel_w"]):
        vel_c = vel[:, c:c + 1] * m
        metrics[f"{name}_mean"] = torch.sum(torch.abs(vel_c)) / n_fluid
        metrics[f"{name}_max"] = torch.max(torch.abs(vel_c))
    return metrics


def reconstruct_velocity_from_noise_pred(predictor, noise_pred, x_t, t, img):
    """x0_hat from eps_hat -> frozen D3D decode -> denorm -> mask.

    noise_pred, x_t: (B*ld, C, lh, lw) as ``predictor.forward`` returns them;
    t: (B*ld,); img: (B, S, 1, H, W). Returns (B, S, 3, H, W) float32.
    The VAE's parameters stay frozen (``requires_grad=False``); gradients
    flow to ``noise_pred`` through the decoder, which runs at the
    predictor's compute dtype with each residual block rematerialized
    (storing its activations at 256^2 x 11 would not fit).
    """
    b, s = img.shape[0], img.shape[1]
    c, lh, lw = x_t.shape[1], x_t.shape[2], x_t.shape[3]
    # latent depth from the tensor itself (b*ld rows), like the reference's
    # explicit latent_depth arg: reshaping with s would fail whenever the
    # VAE compresses depth
    ld = x_t.shape[0] // b
    sched = predictor.scheduler

    sac = torch.clamp(sched.sqrt_alphas_cumprod[t], min=0.0)[:, None, None, None]
    somac = sched.sqrt_one_minus_alphas_cumprod[t][:, None, None, None]
    x0_pred = (x_t - somac * noise_pred) / (sac + 1e-8)
    z = x0_pred.reshape(b, ld, c, lh, lw).transpose(1, 2)      # (B, C, ld, lh, lw)

    vel = predictor.vae.decode_3d(z.to(predictor.compute_dtype))
    vel = predictor.normalizer["output"].inverse(vel.float(), channel_axis=1)
    h, w = img.shape[-2], img.shape[-1]
    if vel.shape[2] != s or vel.shape[3] != h or vel.shape[4] != w:
        vel = interpolate_trilinear(vel, s, h, w)
    return vel.transpose(1, 2) * img                            # (B, S, 3, H, W)


def component_weighted_velocity_loss(
    velocity_pred, velocity_target, mask,
    weight_u=1.0, weight_v=1.0, weight_w=1.0,
    eps=1e-8, normalize_per_component=True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked per-component MAE with u/v/w weights (physics.py:676-747)."""
    if velocity_pred.ndim != 5 or velocity_pred.shape[2] != 3:
        raise ValueError(f"velocity must be (B, S, 3, H, W), got {tuple(velocity_pred.shape)}")
    velocity_pred = velocity_pred * mask
    velocity_target = velocity_target * mask
    mask_c = mask[:, :, 0]
    components = {}
    total = velocity_pred.new_zeros((), dtype=torch.float32)
    for i, (name, wgt) in enumerate(zip("uvw", (weight_u, weight_v, weight_w))):
        pred_c = velocity_pred[:, :, i]
        target_c = velocity_target[:, :, i]
        error = torch.abs(pred_c - target_c)
        if normalize_per_component:
            target_scale = torch.sum(torch.abs(target_c) * mask_c) / (torch.sum(mask_c) + eps)
            loss_c = torch.sum(error * mask_c) / (torch.sum(mask_c) * target_scale + eps)
        else:
            loss_c = torch.sum(error * mask_c) / (torch.sum(mask_c) + eps)
        components[f"loss_{name}"] = loss_c.detach()
        total = total + wgt * loss_c
    return total / (weight_u + weight_v + weight_w), components


def compute_per_component_metrics(velocity_pred, velocity_target, mask, eps=1e-8):
    """Per-component MAE / relative error / variance ratio over fluid voxels
    (physics.py:750-803), masked moments."""
    velocity_pred = velocity_pred * mask
    velocity_target = velocity_target * mask
    m = mask[:, :, 0]
    n = torch.sum(m) + eps

    def masked_std(x):
        mean = torch.sum(x * m) / n
        var = torch.sum(torch.square(x - mean) * m) / torch.clamp(n - 1, min=1)
        return torch.sqrt(var)

    metrics = {}
    for i, name in enumerate("uvw"):
        p = velocity_pred[:, :, i]
        tgt = velocity_target[:, :, i]
        mae = torch.sum(torch.abs(p - tgt) * m) / n
        target_mag = torch.sum(torch.abs(tgt) * m) / n + eps
        pred_std = masked_std(p)
        target_std = masked_std(tgt) + eps
        metrics[f"{name}_mae"] = mae
        metrics[f"{name}_rel_error"] = mae / target_mag
        metrics[f"{name}_var_ratio"] = pred_std / target_std
        metrics[f"{name}_pred_std"] = pred_std
        metrics[f"{name}_target_std"] = target_std
    return metrics

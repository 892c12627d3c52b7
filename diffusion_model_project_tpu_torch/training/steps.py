"""Training and validation steps (the port's copy of the JAX package's
``training/steps.py``).

The diffusion step mirrors the reference hot loop (helper.py:277-447):
encode the target with the frozen E3D -> one timestep a latent slice ->
q_sample -> UNet eps prediction -> noise-space cost (+ optional physics /
velocity losses through the frozen decoder) -> Adam update of the UNet
parameters only. The forward and ``loss.backward()`` run inside
``models.layers.train_trace()``: the GroupNorm and self-attention calls
that need a gradient (the UNet's and the decoder's) take their plain
versions under autograd (two-pass GN statistics), as K1 and K2 have no
backward; the frozen encodes of the target and the 2D input still launch
K1. The validation step runs outside it, under ``torch.no_grad()``, and
launches K1 and K2 for every call.

Gradient accumulation splits the batch into ``accum_steps`` microbatches
and averages their gradients (the JAX step's ``lax.scan``). ``eps_pred``,
``noise`` and ``x_t`` are in the port's layout, (B*ld, C, lh, lw), so the
JAX step's channels-last transposes have no counterpart.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..losses.metrics import cost_function
from ..losses.physics import (PhysicsLoss, component_weighted_velocity_loss,
                              compute_physics_metrics, reconstruct_velocity_from_noise_pred)
from ..models.layers import train_trace

BATCH_KEYS = ("img", "U_2d", "U")


def batch_tensors(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """``batch``'s 'img', 'U_2d' and 'U' (tensors or arrays) as float32
    tensors on ``device``; tensors already so are returned as they are."""
    return {k: torch.as_tensor(batch[k]).to(device, torch.float32) for k in BATCH_KEYS}


def diffusion_loss_fn(
    predictor,
    batch: Dict,
    generator: Optional[torch.Generator] = None,
    *,
    noise: Optional[torch.Tensor] = None,
    t: Optional[torch.Tensor] = None,
    cost_name: str = "normalized_mse_loss_per_component",
    physics: Optional[PhysicsLoss] = None,
    lambda_velocity: float = 0.0,
    velocity_weights: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    velocity_loss_primary: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch keys: 'img' (B,S,1,H,W), 'U_2d' (B,S,3,H,W), 'U' (B,S,3,H,W).
    Noise and timesteps come from ``noise`` / ``t`` where given, else from
    ``generator`` (noise first, then t). Returns (loss, aux): the loss keeps
    its graph to the UNet's parameters; aux holds detached 0-d tensors:
    ``noise_loss``, ``primary_loss`` (the loss before physics / auxiliary
    terms, what the reference logs), ``loss`` and the active components.

    ``velocity_loss_primary`` replaces the noise-prediction cost with the
    masked per-component velocity loss through the frozen decoder
    (helper.py:320-358)."""
    cost = cost_function(cost_name)
    img, v2d, v3d = batch_tensors(batch, predictor.device).values()
    with torch.no_grad():
        x_start = predictor.encode_target(v3d)
    eps_pred, noise, t, x_t = predictor.forward(img, v2d, x_start, noise=noise, t=t,
                                                generator=generator)
    aux = {}

    physics_on = physics is not None and physics.is_active()
    vel_pred = None
    if velocity_loss_primary or physics_on or lambda_velocity > 0:
        vel_pred = reconstruct_velocity_from_noise_pred(predictor, eps_pred, x_t, t, img)

    if velocity_loss_primary:
        loss, comps = component_weighted_velocity_loss(vel_pred, v3d, img, *velocity_weights)
        aux.update(comps)
        aux["noise_loss"] = cost(eps_pred.detach(), noise)
    else:
        loss = cost(eps_pred, noise)
        aux["noise_loss"] = loss.detach()
    aux["primary_loss"] = loss.detach()

    if physics_on:
        phys_total, comps = physics(vel_pred, img)
        loss = loss + phys_total
        aux.update(comps)
    if lambda_velocity > 0 and not velocity_loss_primary:
        vel_loss, comps = component_weighted_velocity_loss(vel_pred, v3d, img, *velocity_weights)
        loss = loss + lambda_velocity * vel_loss
        aux["velocity_loss"] = vel_loss.detach()
        aux.update(comps)
    aux["loss"] = loss.detach()
    return loss, aux


def _microbatches(batch: Dict, noise, t, accum_steps: int):
    """Split a batch (and explicit noise / t, rows ordered sample-major) into
    ``accum_steps`` equal microbatches of samples."""
    b = len(batch["img"])
    if b % accum_steps:
        raise ValueError(f"batch of {b} does not split into {accum_steps} microbatches")
    mb = b // accum_steps
    for k in range(accum_steps):
        rows = slice(k * mb, (k + 1) * mb)
        part = {key: batch[key][rows] for key in BATCH_KEYS}
        n_k = noise.reshape(b, -1)[rows] if noise is not None else None
        t_k = t.reshape(b, -1)[rows].reshape(-1) if t is not None else None
        yield part, n_k, t_k


def make_diffusion_train_step(
    optimizer,
    *,
    cost_name: str = "normalized_mse_loss_per_component",
    physics: Optional[PhysicsLoss] = None,
    lambda_velocity: float = 0.0,
    velocity_weights: Tuple[float, float, float] = (1.0, 1.0, 1.0),
    velocity_loss_primary: bool = False,
    accum_steps: int = 1,
) -> Callable:
    """``train_step(predictor, batch, generator=None, *, noise=None, t=None)
    -> aux``: one optimizer step on the UNet's parameters (``optimizer``:
    ``zero_grad()`` / ``step()``, e.g. ``train_diffusion.make_optimizer``).
    With ``accum_steps > 1`` the batch splits into microbatches, each drawing
    its noise then t from ``generator`` in turn (or taking its rows of
    ``noise`` (B*ld, ...) and ``t`` (B*ld,)); gradients and aux are averaged."""
    common = dict(cost_name=cost_name, physics=physics, lambda_velocity=lambda_velocity,
                  velocity_weights=velocity_weights,
                  velocity_loss_primary=velocity_loss_primary)

    def train_step(predictor, batch: Dict, generator: Optional[torch.Generator] = None, *,
                   noise: Optional[torch.Tensor] = None,
                   t: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        # both the forward and the backward: torch.utils.checkpoint recomputes
        # the decoder's blocks during backward, and must route as the forward did
        with train_trace():
            if accum_steps == 1:
                loss, aux = diffusion_loss_fn(predictor, batch, generator, noise=noise, t=t,
                                              **common)
                loss.backward()
            else:
                aux = {}
                for part, n_k, t_k in _microbatches(batch, noise, t, accum_steps):
                    loss, aux_k = diffusion_loss_fn(predictor, part, generator, noise=n_k,
                                                    t=t_k, **common)
                    (loss / accum_steps).backward()
                    aux = {k: aux.get(k, 0.0) + v for k, v in aux_k.items()}
                aux = {k: v / accum_steps for k, v in aux.items()}
        optimizer.step()
        return aux

    return train_step


def make_diffusion_eval_step(*, cost_name: str = "normalized_mse_loss_per_component",
                             with_physics_metrics: bool = False) -> Callable:
    """``eval_step(predictor, batch, generator=None, *, noise=None, t=None)``
    -> ``{"val_loss": 0-d tensor, ...}`` (reference helper.py:464-552), under
    ``torch.no_grad()``. ``batch``: 'img' (B,S,1,H,W), 'U_2d' and 'U'
    (B,S,3,H,W), tensors or arrays. The noise and the timesteps come from
    ``noise`` / ``t`` where given, else from ``generator`` (noise first, then
    t, as the JAX step splits its key). ``with_physics_metrics`` adds
    ``compute_physics_metrics`` of the velocity decoded from eps_pred."""
    cost = cost_function(cost_name)

    @torch.no_grad()
    def eval_step(predictor, batch: Dict, generator: Optional[torch.Generator] = None, *,
                  noise: Optional[torch.Tensor] = None,
                  t: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        img, v2d, v3d = batch_tensors(batch, predictor.device).values()
        x_start = predictor.encode_target(v3d)
        eps_pred, noise, t, x_t = predictor.forward(img, v2d, x_start, noise=noise, t=t,
                                                    generator=generator)
        metrics = {"val_loss": cost(eps_pred, noise)}
        if with_physics_metrics:
            vel_pred = reconstruct_velocity_from_noise_pred(predictor, eps_pred, x_t, t, img)
            metrics.update(compute_physics_metrics(vel_pred, img))
        return metrics

    return eval_step

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


def refuse_int8(predictor) -> None:
    """Fail fast on an int8 predictor: the quantizers' round and clip have a
    zero gradient almost everywhere, so training through them would yield
    about zero gradients."""
    if getattr(predictor, "unet_int8", False) or getattr(predictor, "vae_int8", False):
        raise ValueError(
            "Training through an int8 predictor (with_unet_int8/with_vae_int8) would yield "
            "zero gradients through the round/clip quantizers; disable int8 for training "
            "(.with_unet_int8(False).with_vae_int8(False)).")


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
        refuse_int8(predictor)
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


# ----------------------------------------------------------------------------
# Cached latents (--cache-latents). The VAE is frozen during diffusion
# training, so the target latents (E3D mu of U) and the conditioning (E2D mu
# of U_2d, the pre-processed mask resized to the latent grid) are the same in
# every epoch: one encode pass fills a card-resident cache, and each epoch
# then runs only the UNet. The loss draws its noise, then its timesteps, as
# diffusion_loss_fn does through predictor.forward, so under the same draws
# it equals the uncached loss. Only the plain noise-prediction configuration
# (the trainer refuses physics and velocity losses, which decode full-res
# velocity every step). Flip augmentation runs through a 4-variant cache:
# latents of flipped volumes are not flips of latents, so every (flip_h,
# flip_z) encode is cached, variant-major, and the dataset's own
# augmentation draws pick the rows (helper.flip_variant_draws).
# ----------------------------------------------------------------------------


def flip_variant_batch(batch: Dict[str, torch.Tensor], flip_h: bool,
                       flip_z: bool) -> Dict[str, torch.Tensor]:
    """The dataset's flip augmentation on a raw batch {'img','U_2d','U'} of
    (B, S, C, H, W) tensors, as ``MicroFlowDataset._augment_sample`` applies
    it to a sample: flip-H mirrors H and negates vy (channel 1) of both
    velocity tensors; flip-Z mirrors the slice axis and negates vz (channel 2)."""
    def flip(x, velocity):
        if flip_h:
            x = torch.flip(x, dims=(-2,))
        if flip_z:
            x = torch.flip(x, dims=(1,))
        if velocity:
            sign = torch.ones(x.shape[2], dtype=x.dtype)
            if flip_h:
                sign[1] = -1.0
            if flip_z:
                sign[2] = -1.0
            x = x * sign.to(x.device).reshape(1, 1, -1, 1, 1)
        return x

    return {"img": flip(batch["img"], velocity=False),
            "U_2d": flip(batch["U_2d"], velocity=True),
            "U": flip(batch["U"], velocity=True)}


@torch.no_grad()
def precompute_latent_cache(predictor, batch: Dict) -> Dict[str, torch.Tensor]:
    """One frozen-VAE encode pass over a raw batch: x0 and z
    (B, ld, C, lh, lw) and m (B, ld, 1, lh, lw), float32 on the predictor's
    device (channels-first; the JAX step's are channels-last)."""
    img, v2d, v3d = batch_tensors(batch, predictor.device).values()
    x_start = predictor.encode_target(v3d)                  # (B, ld, C, lh, lw)
    z, m = predictor.prepare_conditioning(img, v2d)          # (B*ld, C | 1, lh, lw)
    b, ld = x_start.shape[:2]
    return {"x0": x_start, "z": z.reshape(b, ld, *z.shape[1:]),
            "m": m.reshape(b, ld, *m.shape[1:])}


def cached_latent_loss_fn(
    predictor,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    *,
    noise: Optional[torch.Tensor] = None,
    t: Optional[torch.Tensor] = None,
    cost_name: str = "normalized_mse_loss_per_component",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch keys 'x0' / 'z' (B, ld, C, lh, lw), 'm' (B, ld, 1, lh, lw) from
    :func:`precompute_latent_cache`. The noise (B*ld, C, lh, lw) and the
    timesteps (B*ld,) come from ``noise`` / ``t`` where given, else from
    ``generator``, noise first, as ``predictor.forward`` draws them; the loss
    then equals :func:`diffusion_loss_fn`'s for the plain configuration."""
    cost = cost_function(cost_name)
    x0, z, m = batch["x0"], batch["z"], batch["m"]
    b, ld = x0.shape[:2]
    flat = lambda a: a.reshape((b * ld,) + tuple(a.shape[2:]))  # noqa: E731
    x0f, zf, mf = flat(x0), flat(z), flat(m)
    if (noise is None or t is None) and generator is None:
        raise ValueError("cached_latent_loss_fn needs a generator when noise or t is not given")
    if noise is None:
        noise = torch.randn(x0f.shape, generator=generator, device=generator.device)
    if t is None:
        t = torch.randint(0, predictor.num_timesteps, (b * ld,), generator=generator,
                          device=generator.device)
    noise = noise.to(x0f.device, torch.float32).reshape(x0f.shape)
    t = t.to(x0f.device, torch.int64)
    x_t = predictor.scheduler.q_sample(x0f, t, noise)
    loss = cost(predictor._unet_eps(x_t, zf, mf, t), noise)
    aux = {"noise_loss": loss.detach(), "primary_loss": loss.detach(), "loss": loss.detach()}
    return loss, aux


def make_cached_latent_train_step(
    optimizer, *, cost_name: str = "normalized_mse_loss_per_component",
) -> Callable:
    """``train_step(predictor, cached_batch, generator=None, *, noise=None,
    t=None) -> aux``: one optimizer step of the UNet over cached latents."""
    def train_step(predictor, batch, generator=None, *, noise=None, t=None):
        refuse_int8(predictor)
        optimizer.zero_grad(set_to_none=True)
        with train_trace():
            loss, aux = cached_latent_loss_fn(predictor, batch, generator, noise=noise, t=t,
                                              cost_name=cost_name)
            loss.backward()
        optimizer.step()
        return aux

    return train_step


def make_cached_latent_eval_step(
    *, cost_name: str = "normalized_mse_loss_per_component",
) -> Callable:
    """The validation loss over cached latents (the quantity the regular eval
    step computes for the plain configuration), under ``torch.no_grad()``."""
    @torch.no_grad()
    def eval_step(predictor, batch, generator=None, *, noise=None, t=None):
        _, aux = cached_latent_loss_fn(predictor, batch, generator, noise=noise, t=t,
                                       cost_name=cost_name)
        return {"val_loss": aux["noise_loss"]}

    return eval_step

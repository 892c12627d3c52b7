"""The port's ``diffusion_loss_fn`` in its variants through the frozen decoder
(physics losses, the auxiliary velocity loss, ``velocity_loss_primary``) and
``reconstruct_velocity_from_noise_pred`` against the JAX package, on the CPU
in float32, on the tiny predictor of ``tests/test_torch_train_step.py``.

One jitted JAX function computes the three variants' losses, aux and UNet
gradients (and the reconstructed velocity) from one key. Losses and aux
agree within 1e-4 relative, UNet gradients within 1e-4 of max|JAX grad|.
"""
import jax
import numpy as np
import pytest
import torch

from diffusion_model_project_tpu.losses import physics as jphysics
from diffusion_model_project_tpu.models import layers as jlayers
from diffusion_model_project_tpu.training import steps as jsteps

from diffusion_model_project_tpu_torch.losses import physics
from diffusion_model_project_tpu_torch.models.layers import train_trace
from diffusion_model_project_tpu_torch.training import steps

from test_torch_train_step import (COST, assert_grads_close, jax_draws, jax_twin, make_batch,  # noqa: F401
                                   native_conv3d, one_torch_thread, port_grads, port_predictor)

WEIGHTS = (1.0, 2.0, 0.5)
VARIANTS = {
    "physics": dict(lambda_div=0.1, lambda_flow=0.1, lambda_smooth=0.01, lambda_laplacian=0.01),
    "velocity": dict(lambda_velocity=0.1),
    "primary": dict(velocity_loss_primary=True, lambda_div=0.1),
}
AUX_KEYS = {
    "physics": {"divergence", "flow_rate", "smoothness", "laplacian"},
    "velocity": {"velocity_loss", "loss_u", "loss_v", "loss_w"},
    "primary": {"divergence", "loss_u", "loss_v", "loss_w"},
}


def _kwargs(variant, make_physics):
    kw = dict(VARIANTS[variant])
    lambdas = {k: kw.pop(k) for k in list(kw) if k.startswith("lambda_") and k != "lambda_velocity"}
    return dict(kw, physics=make_physics(**lambdas) if lambdas else None,
                velocity_weights=WEIGHTS, cost_name=COST)


@pytest.fixture(scope="module")
def case(native_conv3d):
    pred = port_predictor(seed=8)
    jpred = jax_twin(pred)
    batch = make_batch(12, b=2)
    key = jax.random.key(21)

    @jax.jit
    def run(params, batch, key):
        out = {}
        with jlayers.train_trace():
            for name in VARIANTS:
                kw = _kwargs(name, jphysics.PhysicsLoss)
                out[name] = jax.value_and_grad(
                    lambda p: jsteps.diffusion_loss_fn(p, jpred, batch, key, **kw),
                    has_aux=True)(params)
            x0 = jpred.encode_target(batch["U"])
            eps, _, t, x_t = jpred.forward(batch["img"], batch["U_2d"], x0, rng=key)
            out["velocity_pred"] = jphysics.reconstruct_velocity_from_noise_pred(
                jpred, eps, x_t, t, batch["img"])
        return out

    return pred, batch, key, run(jpred.unet_params, batch, key)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_variants_match_jax(case, variant):
    pred, batch, key, expected = case
    (loss_j, aux_j), grads_j = expected[variant]
    noise, t = jax_draws(key, 2)
    pred.model.requires_grad_(True)
    try:
        with train_trace():
            loss, aux = steps.diffusion_loss_fn(pred, batch, noise=noise, t=t,
                                                **_kwargs(variant, physics.PhysicsLoss))
            loss.backward()
        got = port_grads(pred)
        assert all(p.grad is None for p in pred.vae.parameters())  # the VAE stays frozen
    finally:
        pred.model.requires_grad_(False)
        pred.model.zero_grad(set_to_none=True)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4)
    assert set(aux) == set(aux_j) == {"noise_loss", "primary_loss", "loss"} | AUX_KEYS[variant]
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(aux_j[k]), rtol=1e-4, err_msg=k)
    # the primary loss is logged before the auxiliary terms
    assert aux["loss"].item() > aux["primary_loss"].item()
    assert_grads_close(got, grads_j)


def test_reconstruct_velocity_matches_jax(case):
    pred, batch, key, expected = case
    noise, t = jax_draws(key, 2)
    img = torch.from_numpy(batch["img"])
    x0 = pred.encode_target(torch.from_numpy(batch["U"]))
    with torch.no_grad():
        eps, _, t, x_t = pred.forward(img, torch.from_numpy(batch["U_2d"]), x0, noise=noise, t=t)
        vel = physics.reconstruct_velocity_from_noise_pred(pred, eps, x_t, t, img)
    ref = np.asarray(expected["velocity_pred"])
    assert vel.shape == ref.shape == (2, 3, 3, 16, 16) and vel.dtype == torch.float32
    assert np.abs(vel.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    assert not vel.numpy()[np.broadcast_to(batch["img"] == 0, ref.shape)].any()


def test_reconstruct_rematerializes_the_decoder_and_keeps_its_gradient(case):
    """The dual-branch VAE builds its D3D with remat on: under autograd each
    decoder block runs through torch.utils.checkpoint; the value and the
    gradient to eps_pred equal those of the same decode with remat off, and
    no VAE parameter gets a gradient."""
    pred, batch, key, _ = case
    noise, t = jax_draws(key, 2)
    img = torch.from_numpy(batch["img"])
    x0 = pred.encode_target(torch.from_numpy(batch["U"]))
    with torch.no_grad():
        eps, _, t, x_t = pred.forward(img, torch.from_numpy(batch["U_2d"]), x0, noise=noise, t=t)
    assert pred.vae.decoder_3d.remat  # as the VAE is built
    calls = []
    block = pred.vae.decoder_3d.res1_1
    handle = block.register_forward_pre_hook(lambda *a: calls.append(1))
    try:
        results = []
        for remat in (True, False):
            e = eps.clone().requires_grad_(True)
            trace = train_trace()
            trace.__enter__()
            pred.vae.decoder_3d.remat = remat
            vel = physics.reconstruct_velocity_from_noise_pred(pred, e, x_t, t, img)
            vel.square().sum().backward()
            trace.__exit__(None, None, None)
            results.append((vel.detach(), e.grad))
    finally:
        handle.remove()
        pred.vae.decoder_3d.remat = True
    assert calls == [1, 1, 1]  # the remat pass runs the block twice, the plain one once
    torch.testing.assert_close(results[0][0], results[1][0], rtol=0, atol=0)
    torch.testing.assert_close(results[0][1], results[1][1], rtol=1e-6, atol=0)
    assert all(p.grad is None for p in pred.vae.parameters())

"""The port's whole slice (DDIM ``predict_ddim``) and its weights against the
JAX package, on the CPU in float32.

A tiny predictor (latent 4, UNet (16, 32, 64) with attention '2..2', VAE
(32, 32, 32)) is built by the JAX package, its random params (with nonzero
``final_conv`` and ``proj_out``) are carried into the port, and both run
``predict_ddim`` from the same channels-first noise.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from diffusion_model_project_tpu.diffusion.predictor import (
    LatentDiffusionPredictor as JPredictor)
from diffusion_model_project_tpu.diffusion.scheduler import (
    DiffusionScheduler as JScheduler, ddim_timesteps as j_ddim_timesteps)
from diffusion_model_project_tpu.utils.torch_export import export_predictor

from diffusion_model_project_tpu_torch.diffusion.predictor import LatentDiffusionPredictor
from diffusion_model_project_tpu_torch.diffusion.scheduler import (
    TABLES, DiffusionScheduler, ddim_timesteps)
from diffusion_model_project_tpu_torch.utils import weights

from test_torch_models import randomize_zero_inits
from test_torch_train_step import one_torch_thread  # noqa: F401

LATENT, S, HW, T = 4, 3, 32, 1000
UNET_KW = dict(in_channels=2 * LATENT + 1, out_channels=LATENT, features=(16, 32, 64),
               kernel_size=3, padding_mode="zeros", activation="silu", final_activation=None,
               attention="2..2", dropout=0.0, time_embedding_dim=64)
VAE_FEATURES = (32, 32, 32)
NORM_OUTPUT = [2.1e-2, 1.6e-2, 7.9e-3]


@pytest.fixture(scope="module")
def jax_predictor():
    rng = np.random.default_rng(11)
    pred = JPredictor.create(dict(UNET_KW), rng=jax.random.key(3), num_slices=S,
                             num_timesteps=T, distance_transform=True, latent_channels=LATENT,
                             image_hw=(HW, HW), vae_features=VAE_FEATURES)
    pred = dataclasses.replace(pred, unet_params=randomize_zero_inits(pred.unet_params, rng))
    return pred.set_normalizer({"input": [1.0], "output": NORM_OUTPUT})


def _port_predictor(jpred) -> LatentDiffusionPredictor:
    pred = LatentDiffusionPredictor.create(
        dict(UNET_KW), device="cpu", num_timesteps=T,
        latent_channels=LATENT, vae_features=VAE_FEATURES)
    weights.load_flax_params(pred, jpred.unet_params, jpred.vae_params)
    return pred.set_normalizer({"input": [1.0], "output": NORM_OUTPUT})


def test_predict_ddim_slice_matches_jax(jax_predictor):
    rng = np.random.default_rng(5)
    b = 2
    img = (rng.random((b, S, 1, HW, HW)) > 0.3).astype(np.float32)
    img[1, 2] = 1.0  # one all-fluid slice
    vel = (rng.standard_normal((b, S, 3, HW, HW)) * 1e-2).astype(np.float32)
    vel[:, :, 2] = 0.0
    noise = rng.standard_normal((b * S, LATENT, HW // 4, HW // 4)).astype(np.float32)

    expected = np.asarray(jax_predictor.predict_ddim(img, vel, num_steps=5, noise=noise))
    pred = _port_predictor(jax_predictor)
    got = pred.predict_ddim(torch.from_numpy(img), torch.from_numpy(vel), num_steps=5,
                            noise=torch.from_numpy(noise)).numpy()
    assert got.shape == expected.shape == (b, S, 3, HW, HW)
    scale = np.abs(expected).max()
    assert scale > 0
    assert np.abs(got - expected).max() <= 1e-4 * scale


def test_state_dict_keys_match_jax_export_and_load_strict(jax_predictor):
    exported = export_predictor(jax_predictor)
    pred = _port_predictor(jax_predictor)
    assert set(pred.state_dict()) == set(exported)
    pred.load_state_dict(weights.to_tensors(exported), strict=True)
    # the port's own assembly of the same state dict agrees key for key
    own = weights.export_predictor_parts(
        unet_params=jax_predictor.unet_params, vae_params=jax_predictor.vae_params,
        scheduler=pred.scheduler, norm_input=[1.0], norm_output=NORM_OUTPUT,
        distance_transform=True)
    assert set(own) == set(exported)
    for k in exported:
        np.testing.assert_array_equal(own[k], np.asarray(exported[k], np.float32), err_msg=k)


def test_scheduler_tables_and_ddim_timesteps_match_jax():
    jsched, sched = JScheduler.create(T), DiffusionScheduler(T)
    for name in TABLES:
        np.testing.assert_array_equal(getattr(sched, name).numpy(),
                                      np.asarray(getattr(jsched, name)), err_msg=name)
    for n in (1, 5, 50, 1000):
        np.testing.assert_array_equal(ddim_timesteps(T, n), j_ddim_timesteps(T, n))


def test_scheduler_steps_match_jax():
    rng = np.random.default_rng(9)
    jsched, sched = JScheduler.create(T), DiffusionScheduler(T)
    x, eps, noise = (rng.standard_normal((4, LATENT, 8, 8)).astype(np.float32) for _ in range(3))
    t = np.array([0, 1, 500, 999])
    j = lambda a: np.asarray(a)
    tt = [torch.from_numpy(a) for a in (x, eps, noise)]
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        sched.q_sample(tt[0], torch.from_numpy(t), tt[2]).numpy(),
        j(jsched.q_sample(x, t, noise)), **tol)
    np.testing.assert_allclose(
        sched.p_sample(tt[1], tt[0], torch.from_numpy(t), tt[2], clip_range=(-30.0, 30.0)).numpy(),
        j(jsched.p_sample(eps, x, t, noise, clip_range=(-30.0, 30.0))), **tol)
    for t_prev, eta in ((480, 0.0), (480, 0.7), (-1, 0.7)):
        np.testing.assert_allclose(
            sched.ddim_sample(tt[1], tt[0], torch.full((4,), 500), t_prev, eta=eta,
                              noise=tt[2]).numpy(),
            j(jsched.ddim_sample(eps, x, np.full(4, 500), t_prev, eta=eta, noise=noise)), **tol)


def test_predict_ddim_eta_draws_from_the_generator(jax_predictor):
    pred = _port_predictor(jax_predictor)
    rng = np.random.default_rng(6)
    img = torch.from_numpy((rng.random((1, S, 1, HW, HW)) > 0.3).astype(np.float32))
    vel = torch.from_numpy((rng.standard_normal((1, S, 3, HW, HW)) * 1e-2).astype(np.float32))
    with pytest.raises(ValueError, match="generator"):
        pred.predict_ddim(img, vel, num_steps=3, eta=0.5)
    runs = [pred.predict_ddim(img, vel, num_steps=3, eta=eta,
                              generator=torch.Generator().manual_seed(seed))
            for eta, seed in ((0.5, 1), (0.5, 1), (0.5, 2), (0.0, 1))]
    assert all(torch.isfinite(r).all() for r in runs)
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2]) and not torch.equal(runs[0], runs[3])

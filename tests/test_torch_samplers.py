"""The port's DDPM (``predict``) and DPM-Solver++ (``predict_dpm``) samplers
against the JAX package's, on the CPU in float32.

The tiny predictor of ``tests/test_torch_predictor.py`` (latent 4, UNet
(16, 32, 64) with attention '2..2', VAE (32, 32, 32), 3 slices of 32^2) is
built by the JAX package and carried into the port with ``utils/weights.py``;
both run from the same channels-first noise. DDPM is held through one shared
``step_noise`` table: the port draws its own step noise from a
``torch.Generator`` in step order, the JAX package from a key folded by t.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from diffusion_model_project_tpu.diffusion.scheduler import (
    DiffusionScheduler as JScheduler, dpm_solver_coefficients as j_dpm_coefficients)

from diffusion_model_project_tpu_torch.diffusion.predictor import LatentDiffusionPredictor
from diffusion_model_project_tpu_torch.diffusion.scheduler import (
    DiffusionScheduler, ddim_timesteps, dpm_solver_coefficients)
from diffusion_model_project_tpu_torch.utils import weights

from test_torch_predictor import LATENT, NORM_OUTPUT, S, HW, UNET_KW, VAE_FEATURES
from test_torch_predictor import jax_predictor  # noqa: F401  (module fixture)
from test_torch_train_step import one_torch_thread  # noqa: F401

B = 1
LH = HW // 4


def with_t(jpred, num_timesteps: int):
    """The JAX predictor with another T (the params do not depend on it)."""
    return dataclasses.replace(jpred, num_timesteps=num_timesteps,
                               scheduler=JScheduler.create(num_timesteps))


def port_of(jpred, **kwargs) -> LatentDiffusionPredictor:
    pred = LatentDiffusionPredictor.create(
        dict(UNET_KW), device="cpu", num_timesteps=jpred.num_timesteps,
        latent_channels=LATENT, vae_features=VAE_FEATURES, **kwargs)
    weights.load_flax_params(pred, jpred.unet_params, jpred.vae_params)
    return pred.set_normalizer({"input": [1.0], "output": NORM_OUTPUT})


def inputs(seed: int, steps: int = 0):
    rng = np.random.default_rng(seed)
    img = (rng.random((B, S, 1, HW, HW)) > 0.3).astype(np.float32)
    vel = (rng.standard_normal((B, S, 3, HW, HW)) * 1e-2).astype(np.float32)
    vel[:, :, 2] = 0.0
    noise = rng.standard_normal((B * S, LATENT, LH, LH)).astype(np.float32)
    table = rng.standard_normal((steps, B * S, LATENT, LH, LH)).astype(np.float32)
    return img, vel, noise, table


def assert_close_to_jax(got: torch.Tensor, expected) -> None:
    expected = np.asarray(expected)
    got = got.numpy()
    assert got.shape == expected.shape == (B, S, 3, HW, HW)
    scale = np.abs(expected).max()
    assert scale > 0 and np.isfinite(got).all()
    assert np.abs(got - expected).max() <= 1e-4 * scale


@pytest.mark.parametrize("num_timesteps", [10, 1])
def test_predict_ddpm_matches_jax(jax_predictor, num_timesteps):
    # T = 10 runs the ancestral loop from one shared step_noise table; T = 1
    # the one-step branch
    jpred = with_t(jax_predictor, num_timesteps)
    img, vel, noise, table = inputs(21, num_timesteps)
    step_noise = table if num_timesteps > 1 else None
    expected = jax.jit(lambda p, n, s: p.predict(
        img, vel, noise=n, step_noise=s, rng=None if s is not None else jax.random.key(0)))(
        jpred, noise, step_noise)
    pred = port_of(jpred)
    got = pred.predict(torch.from_numpy(img), torch.from_numpy(vel),
                       noise=torch.from_numpy(noise),
                       step_noise=None if step_noise is None else torch.from_numpy(table))
    assert_close_to_jax(got, expected)


@pytest.mark.parametrize("order,num_timesteps,num_steps", [
    (1, 1000, 5), (2, 10, 20)])  # the second with more steps than T
def test_predict_dpm_matches_jax(jax_predictor, order, num_timesteps, num_steps):
    jpred = with_t(jax_predictor, num_timesteps)
    img, vel, noise, _ = inputs(22)
    expected = jax.jit(lambda p, n: p.predict_dpm(img, vel, num_steps=num_steps, order=order,
                                                  noise=n))(jpred, noise)
    got = port_of(jpred).predict_dpm(torch.from_numpy(img), torch.from_numpy(vel),
                                     num_steps=num_steps, order=order,
                                     noise=torch.from_numpy(noise))
    assert_close_to_jax(got, expected)


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("num_timesteps,num_steps", [(1000, 10), (1000, 5), (1000, 50),
                                                     (20, 5), (10, 20)])
def test_dpm_solver_coefficients_match_jax(order, num_timesteps, num_steps):
    # the port computes in float64 from the float32 table, the JAX package in
    # float32: they agree to float32 rounding (a few 1e-6 relative at most
    # over these step counts)
    sched = DiffusionScheduler(num_timesteps)
    ts = np.unique(ddim_timesteps(num_timesteps, num_steps))[::-1]
    got = dpm_solver_coefficients(sched.alphas_cumprod, ts, order=order)
    expected = j_dpm_coefficients(np.asarray(JScheduler.create(num_timesteps).alphas_cumprod),
                                  ts, order=order)
    assert set(got) == set(expected)
    np.testing.assert_array_equal(got["t"], np.asarray(expected["t"]))
    for k in ("alpha_cur", "sigma_cur", "sigma_ratio", "x0_coef", "c2"):
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], np.asarray(expected[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert (got["c2"] != 0).sum() == (max(len(ts) - 2, 0) if order == 2 else 0)


def test_dpm_solver_coefficients_refuse_what_jax_refuses():
    ac = DiffusionScheduler(10).alphas_cumprod
    for fn in (dpm_solver_coefficients, j_dpm_coefficients):
        with pytest.raises(ValueError, match="order must be 1 or 2"):
            fn(np.asarray(ac), np.array([9, 5, 0]), order=3)
        with pytest.raises(ValueError, match="strictly decreasing"):
            fn(np.asarray(ac), np.array([9, 9, 0]), order=2)


def test_predict_needs_a_generator_or_a_table(jax_predictor):
    jpred = with_t(jax_predictor, 10)
    img, vel, noise, table = inputs(23, 10)
    with pytest.raises(ValueError, match="needs rng"):
        jpred.predict(img, vel, noise=noise)
    pred = port_of(jpred)
    args = (torch.from_numpy(img), torch.from_numpy(vel))
    with pytest.raises(ValueError, match="needs a generator"):
        pred.predict(*args, noise=torch.from_numpy(noise))
    # a table without initial noise still needs a generator for x_T
    with pytest.raises(ValueError, match="generator"):
        pred.predict(*args, step_noise=torch.from_numpy(table))


def test_predict_draws_step_noise_from_the_generator_in_step_order(jax_predictor):
    # without a table, step i takes the i-th draw after x_T's: the same
    # numbers as a table made from the same generator
    pred = port_of(with_t(jax_predictor, 10))
    img, vel, _, _ = inputs(24)
    args = (torch.from_numpy(img), torch.from_numpy(vel))
    runs = [pred.predict(*args, generator=torch.Generator().manual_seed(seed))
            for seed in (5, 5, 6)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])
    gen = torch.Generator().manual_seed(5)
    shape = (B * S, LATENT, LH, LH)
    x_t = torch.randn(shape, generator=gen)
    table = torch.stack([torch.randn(shape, generator=gen) for _ in range(10)])
    torch.testing.assert_close(pred.predict(*args, noise=x_t, step_noise=table), runs[0],
                               rtol=0, atol=0)


def test_vae_depth_factor_must_match_the_encoder(jax_predictor):
    # the shipped Encoder preserves depth: factor 2 raises in both packages,
    # before any reshape
    img, vel, noise, _ = inputs(25)
    with pytest.raises(ValueError, match="vae_depth_factor=2"):  # raised while tracing
        jax.jit(lambda p: p.predict_ddim(img, vel, num_steps=2, noise=noise))(
            dataclasses.replace(jax_predictor, vae_depth_factor=2))
    pred = port_of(jax_predictor, vae_depth_factor=2)
    with pytest.raises(ValueError, match="vae_depth_factor=2"):
        pred.predict_ddim(torch.from_numpy(img), torch.from_numpy(vel), num_steps=2,
                          noise=torch.from_numpy(noise))


def test_depth_compressing_vae_resizes_back(jax_predictor, monkeypatch):
    # a VAE that halves depth: both packages' 2D encoders are stubbed by the
    # same mean over slice pairs ahead of the real encoder, and the decoder
    # returns ld slices; conditioning features and the decoded volume go
    # through the trilinear resizes (JAX predictor.py:280-284, 396-397), and
    # the port holds to the JAX package's numbers there
    from diffusion_model_project_tpu.diffusion.predictor import (
        LatentDiffusionPredictor as JPredictor)

    s, ld = 4, 2
    vae_apply = JPredictor._vae_apply

    def halving_vae_apply(self, variables, x, method=None, **kwargs):
        if method == "encode_2d_deterministic":          # (B, S, H, W, C)
            x = x.reshape(x.shape[0], ld, s // ld, *x.shape[2:]).mean(2)
        return vae_apply(self, variables, x, method=method, **kwargs)

    monkeypatch.setattr(JPredictor, "_vae_apply", halving_vae_apply)
    jpred = dataclasses.replace(jax_predictor, vae_depth_factor=2)
    pred = port_of(jax_predictor, vae_depth_factor=2)
    encode = pred.vae.encode_2d_deterministic
    pred.vae.encode_2d_deterministic = lambda x: encode(   # (B, C, S, H, W)
        x.reshape(x.shape[0], x.shape[1], ld, s // ld, HW, HW).mean(3))

    rng = np.random.default_rng(26)
    img = (rng.random((B, s, 1, HW, HW)) > 0.3).astype(np.float32)
    vel = (rng.standard_normal((B, s, 3, HW, HW)) * 1e-2).astype(np.float32)
    noise = rng.standard_normal((B * ld, LATENT, LH, LH)).astype(np.float32)
    args = (torch.from_numpy(img), torch.from_numpy(vel))

    j_z, j_m = jpred.prepare_conditioning(img, vel)          # channels-last
    z_cond, m_cond = pred.prepare_conditioning(*args)
    assert z_cond.shape == (B * ld, LATENT, LH, LH) and m_cond.shape == (B * ld, 1, LH, LH)
    for got, expected in ((z_cond, j_z), (m_cond, j_m)):
        expected = np.moveaxis(np.asarray(expected), -1, 1)
        assert np.abs(got.numpy() - expected).max() <= 1e-4 * np.abs(expected).max()

    expected = np.asarray(jax.jit(lambda p, n: p.predict_ddim(img, vel, num_steps=2, noise=n))(
        jpred, noise))
    out = pred.predict_ddim(*args, num_steps=2, noise=torch.from_numpy(noise)).numpy()
    assert out.shape == expected.shape == (B, s, 3, HW, HW) and np.isfinite(out).all()
    scale = np.abs(expected).max()
    assert scale > 0 and np.abs(out - expected).max() <= 1e-4 * scale
    assert (out[np.broadcast_to(img, out.shape) == 0] == 0).all()

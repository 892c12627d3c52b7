"""The port's ``losses/physics.py`` against the JAX package's, on the CPU in
float32: every loss term, ``PhysicsLoss`` with its components and its
gradient, ``compute_physics_metrics``, and the per-component velocity loss
and metrics, on the same inputs made from a numpy seed. Values agree within
rtol 1e-5; gradients within 1e-4 of max|JAX grad|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_project_tpu.losses import physics as jphysics

from diffusion_model_project_tpu_torch.losses import physics

from test_torch_train_step import one_torch_thread  # noqa: F401

B, D, H, W = 2, 5, 12, 10


def _inputs(seed, mask_p=0.3):
    """velocity (B,3,D,H,W) with a mean flow along x, mask (B,1,D,H,W)."""
    rng = np.random.default_rng(seed)
    vel = (rng.standard_normal((B, 3, D, H, W)) * 0.2).astype(np.float32)
    vel[:, 0] += 1.0
    mask = (rng.random((B, 1, D, H, W)) > mask_p).astype(np.float32)
    return vel, mask


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


TERMS = {
    "divergence_loss_masked": {},
    "flow_rate_consistency_loss": {},
    "no_slip_loss": {},
    "smoothness_loss": {"normalize": True},
    "smoothness_loss-raw": {"normalize": False},
    "laplacian_smoothness_loss": {"normalize": True},
    "laplacian_smoothness_loss-raw": {"normalize": False},
}


@pytest.mark.parametrize("term", list(TERMS))
@pytest.mark.parametrize("mask_p", [0.3, 0.0])
def test_loss_terms_match_jax(term, mask_p):
    vel, mask = _inputs(1, mask_p)
    name = term.split("-")[0]
    expected = float(getattr(jphysics, name)(vel, mask, **TERMS[term]))
    got = getattr(physics, name)(_t(vel), _t(mask), **TERMS[term])
    assert got.ndim == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), expected, rtol=1e-5)


def test_divergence_loss_refuses_other_shapes():
    vel, mask = _inputs(2)
    with pytest.raises(ValueError, match="velocity"):
        physics.divergence_loss_masked(_t(vel[:, :2]), _t(mask))


LAMBDAS = [dict(lambda_div=0.1, lambda_flow=0.2, lambda_smooth=0.01, lambda_laplacian=0.03),
           dict(lambda_div=0.5), dict(lambda_smooth=0.2, normalize_smoothness=False), {}]


@pytest.mark.parametrize("kw", LAMBDAS)
def test_physics_loss_and_its_gradient_match_jax(kw):
    """(B, S, 3, H, W) velocity and (B, S, 1, H, W) mask; only active terms
    are computed; the gradient to the velocity against jax.grad."""
    vel, mask = _inputs(3)
    vel_s, mask_s = np.swapaxes(vel, 1, 2), np.swapaxes(mask, 1, 2)
    jloss = jphysics.PhysicsLoss(**kw)
    (total_j, comps_j), grad_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(vel_s), jnp.asarray(mask_s))
    loss = physics.PhysicsLoss(**kw)
    assert loss.is_active() == jloss.is_active() == bool(kw)
    v = _t(vel_s).requires_grad_(True)
    total, comps = loss(v, _t(mask_s))
    assert set(comps) == set(comps_j)
    np.testing.assert_allclose(total.item(), float(total_j), rtol=1e-5)
    for k in comps:
        assert not comps[k].requires_grad
        np.testing.assert_allclose(comps[k].item(), float(comps_j[k]), rtol=1e-5)
    assert loss(v, _t(mask_s), return_components=False).item() == total.item()
    if not kw:
        assert total.item() == 0.0
        return
    total.backward()
    grad_j = np.asarray(grad_j)
    assert np.abs(v.grad.numpy() - grad_j).max() <= 1e-4 * np.abs(grad_j).max()


@pytest.mark.parametrize("layout", ["bs3hw", "b3dhw"])
def test_compute_physics_metrics_match_jax(layout):
    vel, mask = _inputs(4)
    if layout == "bs3hw":
        vel, mask = np.swapaxes(vel, 1, 2), np.swapaxes(mask, 1, 2)
    expected = {k: float(v) for k, v in
                jax.jit(jphysics.compute_physics_metrics)(vel, mask).items()}
    got = physics.compute_physics_metrics(_t(vel), _t(mask))
    assert set(got) == set(expected) and len(got) == 13
    for k, v in got.items():
        assert v.ndim == 0
        np.testing.assert_allclose(v.item(), expected[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_flow_rate_cv_is_zero_without_mean_flow():
    vel, mask = _inputs(5)
    vel[:, 0] = 0.0
    expected = float(jphysics.compute_physics_metrics(vel, mask)["flow_rate_cv"])
    assert physics.compute_physics_metrics(_t(vel), _t(mask))["flow_rate_cv"].item() \
        == expected == 0.0


@pytest.mark.parametrize("weights,normalize", [((1.0, 1.0, 1.0), True), ((1.0, 2.0, 0.5), True),
                                               ((1.0, 1.0, 1.0), False)])
def test_component_weighted_velocity_loss_matches_jax(weights, normalize):
    vel, mask = _inputs(6)
    target, _ = _inputs(7)
    pred, target, m = (np.swapaxes(a, 1, 2) for a in (vel, target, mask))
    total_j, comps_j = jphysics.component_weighted_velocity_loss(
        pred, target, m, *weights, normalize_per_component=normalize)
    total, comps = physics.component_weighted_velocity_loss(
        _t(pred), _t(target), _t(m), *weights, normalize_per_component=normalize)
    np.testing.assert_allclose(total.item(), float(total_j), rtol=1e-5)
    assert set(comps) == set(comps_j) == {"loss_u", "loss_v", "loss_w"}
    for k in comps:
        np.testing.assert_allclose(comps[k].item(), float(comps_j[k]), rtol=1e-5)
    with pytest.raises(ValueError, match="velocity"):
        physics.component_weighted_velocity_loss(_t(vel), _t(target), _t(m))


def test_compute_per_component_metrics_match_jax():
    vel, mask = _inputs(8)
    target, _ = _inputs(9)
    pred, target, m = (np.swapaxes(a, 1, 2) for a in (vel, target, mask))
    expected = {k: float(v) for k, v in
                jphysics.compute_per_component_metrics(pred, target, m).items()}
    got = physics.compute_per_component_metrics(_t(pred), _t(target), _t(m))
    assert set(got) == set(expected) and len(got) == 15
    for k, v in got.items():
        np.testing.assert_allclose(v.item(), expected[k], rtol=1e-5, err_msg=k)

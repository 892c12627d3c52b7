"""The port's losses (``losses/metrics.py``) and end-to-end evaluation
metrics (``losses/eval_metrics.py``) against the JAX package's, on the CPU.

Every ``cost_function`` entry runs on the same numpy-seeded float32 inputs
in both packages, on 4D and 5D tensors, with and without per-channel weights
and masks, at rtol 1e-5 (float32 means in another order). The KL forms
likewise; ``divergence_loss`` also against a float64 numpy divergence whose
edges are one-sided differences. The evaluation metrics are numpy on both
sides and agree within 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_project_tpu.losses import eval_metrics as j_eval
from diffusion_model_project_tpu.losses import metrics as jm

from diffusion_model_project_tpu_torch.losses import eval_metrics, metrics

from test_torch_train_step import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-7
SHAPES = {"4d": (3, 4, 6, 7), "5d": (2, 3, 4, 5, 6)}


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    out = rng.standard_normal(shape).astype(np.float32)
    target = rng.standard_normal(shape).astype(np.float32)
    mask = (rng.random(shape[:1] + (1,) + shape[2:]) > 0.3).astype(np.float32)
    weight = rng.random(shape[1]).astype(np.float32) + 0.1
    return out, target, mask, weight


def _both(name, args, kwargs):
    expected = np.asarray(getattr(jm, name)(*map(jnp.asarray, args), **kwargs))
    t_kwargs = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                for k, v in kwargs.items()}
    got = getattr(metrics, name)(*map(torch.from_numpy, args), **t_kwargs).numpy()
    assert got.shape == expected.shape, name
    np.testing.assert_allclose(got, expected, rtol=RTOL, atol=ATOL, err_msg=name)


PLAIN = ["mse_loss", "mae_loss", "huber_loss", "normalized_mae_loss"]
PER_COMPONENT = ["mae_loss_per_component", "mse_loss_per_component",
                 "normalized_mae_loss_per_component", "normalized_mse_loss_per_component"]
PER_CHANNEL = ["mae_loss_per_channel", "normalized_mae_loss_per_channel",
               "normalized_mse_per_channel"]


def test_registry_is_jaxs():
    assert set(metrics._REGISTRY) == set(jm._REGISTRY)
    assert set(PLAIN + PER_COMPONENT + PER_CHANNEL) | {
        "normalized_mse_loss", "divergence_loss"} == set(jm._REGISTRY)
    for name in jm._REGISTRY:
        assert metrics.cost_function(name) is getattr(metrics, name)
    with pytest.raises(ValueError, match="Unknown cost function 'nope'"):
        metrics.cost_function("nope")


@pytest.mark.parametrize("reduce", [True, False])
@pytest.mark.parametrize("rank", sorted(SHAPES))
@pytest.mark.parametrize("name", PLAIN)
def test_plain_losses_match_jax(name, rank, reduce):
    out, target, _, _ = _inputs(SHAPES[rank], 1)
    _both(name, (out, target), {"reduce": reduce})


def test_huber_delta_matches_jax():
    out, target, _, _ = _inputs(SHAPES["5d"], 2)
    _both("huber_loss", (out, target), {"delta": 0.3})


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reduce", [True, False])
@pytest.mark.parametrize("rank", sorted(SHAPES))
@pytest.mark.parametrize("name", PER_COMPONENT)
def test_per_component_losses_match_jax(name, rank, reduce, weighted):
    out, target, _, weight = _inputs(SHAPES[rank], 3)
    _both(name, (out, target), {"reduce": reduce,
                                "weight_per_channel": weight if weighted else None})


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rank", sorted(SHAPES))
@pytest.mark.parametrize("name", PER_CHANNEL)
def test_per_channel_losses_match_jax(name, rank, masked):
    out, target, mask, weight = _inputs(SHAPES[rank], 4)
    kwargs = {"mask": mask if masked else None, "reduce": False}
    if name == "mae_loss_per_channel":
        kwargs["weight_per_channel"] = weight
    _both(name, (out, target), kwargs)
    _both(name, (out, target), {**kwargs, "reduce": True})


@pytest.mark.parametrize("rank", sorted(SHAPES))
def test_normalized_mse_loss_matches_jax(rank):
    out, target, _, _ = _inputs(SHAPES[rank], 5)
    _both("normalized_mse_loss", (out, target), {})


def test_divergence_loss_matches_jax_and_its_edges():
    rng = np.random.default_rng(6)
    field = rng.standard_normal((2, 3, 4, 5, 6)).astype(np.float32)
    _both("divergence_loss", (field,), {})
    # jnp.gradient / torch.gradient: central inside, one-sided at both edges
    f = field.astype(np.float64)

    def grad(a, axis):
        a = np.moveaxis(a, axis, -1)
        g = np.empty_like(a)
        g[..., 1:-1] = (a[..., 2:] - a[..., :-2]) / 2
        g[..., 0] = a[..., 1] - a[..., 0]
        g[..., -1] = a[..., -1] - a[..., -2]
        return np.moveaxis(g, -1, axis)

    div = grad(f[:, 0], -1) + grad(f[:, 1], -2) + grad(f[:, 2], -3)
    got = metrics.divergence_loss(torch.from_numpy(field)).item()
    np.testing.assert_allclose(got, np.mean(div ** 2), rtol=RTOL)
    with pytest.raises(ValueError, match="B, 3, D, H, W"):
        metrics.divergence_loss(torch.zeros(2, 2, 3, 3, 3))


def test_kl_forms_match_jax():
    rng = np.random.default_rng(7)
    mu = rng.standard_normal((2, 4, 3, 5, 5)).astype(np.float32)
    logvar = rng.uniform(-3, 2, mu.shape).astype(np.float32)
    sigma = rng.uniform(0.2, 2, mu.shape).astype(np.float32)
    for kwargs in ({"logvar": logvar}, {"sigma": sigma}):
        expected = np.asarray(jm.kl_divergence(jnp.asarray(mu), **{
            k: jnp.asarray(v) for k, v in kwargs.items()}))
        got = metrics.kl_divergence(torch.from_numpy(mu), **{
            k: torch.from_numpy(v) for k, v in kwargs.items()}).numpy()
        np.testing.assert_allclose(got, expected, rtol=RTOL)
    _both("kl_divergence_sum", (mu, logvar), {})
    with pytest.raises(ValueError, match="Provide logvar or sigma"):
        metrics.kl_divergence(torch.from_numpy(mu))


def _eval_arrays(seed, batch=2):
    rng = np.random.default_rng(seed)
    shape = (batch, 3, 3, 8, 8)
    target = rng.standard_normal(shape).astype(np.float32)
    pred = (target + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    mask = (rng.random((batch, 3, 1, 8, 8)) > 0.3).astype(np.float32)
    return pred, target, mask


@pytest.mark.parametrize("masked", [False, True])
def test_eval_metrics_match_jax(masked):
    pred, target, fluid = _eval_arrays(8)
    mask = fluid if masked else None
    norm = (0.5, 0.7, 0.2)
    expected = j_eval.compute_all_metrics(pred, target, norm, mask=mask)
    got = eval_metrics.compute_all_metrics(pred, target, norm, mask=mask)
    assert set(got) == set(expected)
    for k in expected:
        np.testing.assert_allclose(got[k], expected[k], rtol=1e-12, atol=1e-12, err_msg=k)
    for k in (5.0, 10.0, 50.0):
        assert eval_metrics.compute_iou_topk(pred, target, k, mask) == \
            j_eval.compute_iou_topk(pred, target, k, mask)
    assert eval_metrics.compute_accuracy_score(0.25) == j_eval.compute_accuracy_score(0.25)
    assert eval_metrics.compute_sanity_stats(pred, "p") == j_eval.compute_sanity_stats(pred, "p")
    # a 4-D sample is taken as a batch of one, an empty mask gives zeros
    for fn in ("compute_mae_per_component", "compute_cosine_similarity"):
        empty = np.zeros_like(fluid[:1])
        assert getattr(eval_metrics, fn)(pred[0], target[0], empty) == \
            getattr(j_eval, fn)(pred[0], target[0], empty)


def test_iou_top10_keeps_the_references_threshold():
    # the threshold index is n*(100-k)/100 into the DESCENDING sort, so
    # "top 10%" compares the top-90% sets (reference eval:295-330)
    pred, target, _ = _eval_arrays(9, batch=1)
    mags = [np.linalg.norm(a, axis=2).reshape(-1) for a in (pred, target)]

    def iou(keep):
        a, b = (m >= np.sort(m)[::-1][int(len(m) * keep)] for m in mags)
        return float(np.logical_and(a, b).sum() / (np.logical_or(a, b).sum() + 1e-8))

    assert eval_metrics.compute_iou_topk(pred, target, 10.0) == iou(0.9)
    assert iou(0.9) != iou(0.1)

"""The port's TPE sampler (``training/tpe.py``) and MedianPruner
(``training/train_diffusion.py``) against the JAX package's, exactly:

- ``TPESampler.suggest`` and ``RandomSampler.suggest`` give the JAX
  sampler's parameters for the same (seed, trial, history), in the startup
  phase and deep in the Parzen phase, with NaN (pruned) trials in the
  history, on the diffusion space and on a misaligned integer grid;
- ``MedianPruner`` prunes or keeps each report exactly where JAX's does on
  the same curves;

and the JAX package's own ``tests/test_tpe.py`` cases, run on the port.
"""
import math
import random as pyrandom
from types import SimpleNamespace

import numpy as np
import pytest

from diffusion_model_project_tpu.training import tpe as jtpe
from diffusion_model_project_tpu.training import train_diffusion as jtrain

from diffusion_model_project_tpu_torch.training import train_diffusion as td
from diffusion_model_project_tpu_torch.training.tpe import (Dim, RandomSampler, TPESampler,
                                                            diffusion_search_space)


def _space(d=Dim):
    return [d("batch_size", 1, 8, integer=True), d("kernel_size", 3, 7, integer=True, step=2),
            d("levels", 2, 5, integer=True), d("learning_rate", 1e-5, 1e-1, log=True)]


def _objective(p):
    return ((math.log10(p["learning_rate"]) - math.log10(3e-3)) ** 2
            + 0.15 * (p["levels"] - 4) ** 2 + 0.05 * ((p["kernel_size"] - 3) / 2) ** 2
            + 0.02 * (p["batch_size"] - 4) ** 2)


def _run_study(sampler, n_trials, prune_every=0):
    history, best = [], math.inf
    for t in range(n_trials):
        params = sampler.suggest(t, history)
        value = _objective(params)
        if prune_every and t % prune_every == 1:
            value = float("nan")
        history.append((params, value))
        if value == value:
            best = min(best, value)
    return best, history


# ------------------------------------------------------- against the JAX package


@pytest.mark.parametrize("seed,startup,prune_every", [(2024, 10, 0), (7, 3, 0), (1, 3, 4)])
def test_tpe_draws_equal_jax(seed, startup, prune_every):
    _, history = _run_study(TPESampler(_space(), seed=seed, n_startup_trials=startup), 30,
                            prune_every)
    jsampler = jtpe.TPESampler(_space(jtpe.Dim), seed=seed, n_startup_trials=startup)
    for t in range(30):
        assert jsampler.suggest(t, history[:t]) == history[t][0]


def test_random_sampler_draws_equal_jax():
    port, jax_ = RandomSampler(_space(), seed=11), jtpe.RandomSampler(_space(jtpe.Dim), seed=11)
    history = []
    for t in range(40):
        p = port.suggest(t, history)
        assert p == jax_.suggest(t, history)
        history.append((p, _objective(p)))


def test_search_space_and_misaligned_grid_equal_jax():
    args = SimpleNamespace(range_batch_size=[1, 4], range_kernel_size=[3, 6],
                           range_level=[2, 5], range_learning_rate=[1e-5, 1e-2])
    space, jspace = diffusion_search_space(args), jtpe.diffusion_search_space(args)
    assert [vars(d) for d in space] == [vars(d) for d in jspace]
    port, jax_ = TPESampler(space, seed=3, n_startup_trials=2), jtpe.TPESampler(
        jspace, seed=3, n_startup_trials=2)
    history = []
    for t in range(25):
        p = port.suggest(t, history)
        assert p == jax_.suggest(t, history) and p["kernel_size"] in (3, 5)
        history.append((p, (p["kernel_size"] - 3) ** 2 + p["learning_rate"]))


CURVES = [[1.0, 0.5, 0.2], [100.0, 100.0, 100.0], [99.0, 98.0, 97.0], [1.0, 1.0, 1.0],
          [0.5, 500.0, 2.0], [2.0, 0.1, 0.05], [3.0, 3.0, 0.01], [0.9, 0.9, 0.9]]


@pytest.mark.parametrize("startup,warmup", [(1, 0), (2, 0), (2, 1), (5, 0)])
def test_median_pruner_decisions_equal_jax(startup, warmup):
    """Each curve is reported epoch by epoch to both pruners; a curve that
    finishes is completed. The pruned epoch of each curve (or none) agrees."""
    port, jax_ = td.MedianPruner(startup, warmup), jtrain.MedianPruner(startup, warmup)
    decisions = {"port": [], "jax": []}
    for curve in CURVES:
        for name, pruner, exc in (("port", port, td.TrialPruned),
                                  ("jax", jax_, jtrain.TrialPruned)):
            report, pruned_at = pruner.make_report_fn(), None
            for e, v in enumerate(curve):
                try:
                    report(e, v)
                except exc:
                    pruned_at = e
                    break
            if pruned_at is None:
                pruner.complete_trial(report)
            decisions[name].append(pruned_at)
    assert decisions["port"] == decisions["jax"]
    assert any(d is not None for d in decisions["port"]) == (startup < len(CURVES))


def test_seeded_pruner_equals_jax():
    port, jax_ = td.MedianPruner(1), jtrain.MedianPruner(1)
    for p in (port, jax_):
        p.seed_completed({"0": 1.0, "1": 0.5})
    for pruner, exc in ((port, td.TrialPruned), (jax_, jtrain.TrialPruned)):
        report = pruner.make_report_fn()
        report(0, 0.9)
        with pytest.raises(exc):
            report(1, 0.95)  # best 0.9 > median 0.5


# ------------------------------------------------- the JAX package's own cases


def test_dims_respect_bounds_grids_and_log():
    tpe = TPESampler(_space(), seed=7, n_startup_trials=5)
    history = []
    for t in range(40):
        p = tpe.suggest(t, history)
        assert 1 <= p["batch_size"] <= 8 and float(p["batch_size"]).is_integer()
        assert p["kernel_size"] in (3.0, 5.0, 7.0)
        assert 2 <= p["levels"] <= 5 and float(p["levels"]).is_integer()
        assert 1e-5 <= p["learning_rate"] <= 1e-1
        history.append((p, _objective(p)))


def test_suggest_is_pure_function_of_seed_trial_history():
    _, history = _run_study(TPESampler(_space(), seed=2024, n_startup_trials=3), 20)
    b = TPESampler(_space(), seed=2024, n_startup_trials=3)
    for t in (0, 2, 5, 19):
        assert b.suggest(t, history[:t]) == history[t][0]
    c = TPESampler(_space(), seed=1, n_startup_trials=3)
    assert any(c.suggest(t, history[:t]) != history[t][0] for t in range(20))


def test_pruned_nan_trials_are_ignored_by_the_fit():
    tpe = TPESampler(_space(), seed=0, n_startup_trials=2)
    history = [({"batch_size": 4, "kernel_size": 3, "levels": 4, "learning_rate": 3e-3},
                float("nan"))] * 10
    p = tpe.suggest(15, history)
    assert 1e-5 <= p["learning_rate"] <= 1e-1


def test_tpe_beats_random_at_equal_budget():
    tpe_bests, rnd_bests = [], []
    for seed in range(5):
        tpe_bests.append(_run_study(TPESampler(_space(), seed=seed, n_startup_trials=10), 40)[0])
        rnd_bests.append(_run_study(RandomSampler(_space(), seed=seed), 40)[0])
    assert np.mean(tpe_bests) < np.mean(rnd_bests), (tpe_bests, rnd_bests)


def test_tpe_concentrates_near_the_optimum():
    _, history = _run_study(TPESampler(_space(), seed=3, n_startup_trials=10), 60)
    late = [p["learning_rate"] for p, _ in history[30:]]
    close = [lr for lr in late if 3e-4 <= lr <= 3e-2]
    assert len(close) / len(late) > 0.5, sorted(late)


def test_random_sampler_matches_reference_space_semantics():
    rnd = RandomSampler(_space(), seed=11)
    draws = [rnd.suggest(t, []) for t in range(300)]
    lrs = [d["learning_rate"] for d in draws]
    for lo_exp in (-5, -4, -3, -2):
        frac = sum(1 for lr in lrs if 10 ** lo_exp <= lr < 10 ** (lo_exp + 1)) / len(lrs)
        assert 0.15 < frac < 0.35, (lo_exp, frac)
    assert {d["kernel_size"] for d in draws} == {3, 5, 7}
    assert {d["levels"] for d in draws} == {2, 3, 4, 5}


def test_misaligned_integer_range_stays_on_grid():
    d = Dim("kernel_size", 3, 6, integer=True, step=2)
    rng = pyrandom.Random(0)
    assert {d.random(rng) for _ in range(200)} == {3, 5}
    assert {d._from_internal(z) for z in [2.0, 3.0, 3.9, 4.1, 5.0, 5.9, 6.0, 7.5]} == {3, 5}


def test_duplicate_dim_names_rejected():
    with pytest.raises(ValueError, match="duplicate"):
        TPESampler([Dim("x", 0, 1), Dim("x", 0, 1)])
    with pytest.raises(ValueError, match="log dim"):
        Dim("lr", 0.0, 1.0, log=True)

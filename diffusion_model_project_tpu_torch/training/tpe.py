"""Tree-structured Parzen Estimator sampling for ``--mode optimize``.

The port's copy of the JAX package's ``training/tpe.py`` (the port imports
nothing of that package, not even its pure-Python modules). The reference's
optimize mode is an Optuna study with Optuna's default sampler, TPE, and its
default ``MedianPruner``; optuna is not a dependency, so this is an
independent-Parzen TPE in the same spirit as Optuna's default
(``multivariate=False``: one Parzen estimator per parameter):

  - the first ``n_startup_trials`` finished trials draw uniformly
    (log-uniformly for log dims), Optuna's ``n_startup_trials=10`` default;
  - afterwards, finished trials split into good and bad at the
    ``gamma=0.25`` quantile of the objective; per dimension, Parzen mixtures
    ``l(x)`` (good) and ``g(x)`` (bad) are fit with Bergstra's adaptive
    bandwidths plus a uniform prior component; ``n_candidates`` samples are
    drawn from ``l`` and the one maximising ``log l(x) - log g(x)`` (the
    expected-improvement surrogate) is chosen.

Determinism (``training/train_diffusion.py::optimize``):
``suggest(trial_idx, history)`` is a pure function of
``(seed, trial_idx, history)``, so a resumed study that replays the recorded
history re-draws the same parameters for any trial it retries, and draws
what the JAX package's sampler draws.
"""
import math
import random as pyrandom
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple


@dataclass(frozen=True)
class Dim:
    """One search dimension over [lo, hi] (inclusive for integer dims).

    ``log=True`` fits/samples in log space (the learning-rate dim —
    reference train.py:291 ``suggest_float(..., log=True)``); ``integer``
    rounds to the step grid anchored at ``lo`` (kernel sizes use step=2 to
    stay odd, reference train.py:289 ``suggest_int(..., step=2)``).
    """
    name: str
    lo: float
    hi: float
    log: bool = False
    integer: bool = False
    step: int = 1

    def __post_init__(self):
        if not (self.hi >= self.lo):
            raise ValueError(f"{self.name}: hi {self.hi} < lo {self.lo}")
        if self.log and self.lo <= 0:
            raise ValueError(f"{self.name}: log dim needs lo > 0")
        if self.integer and self.step < 1:
            raise ValueError(f"{self.name}: integer step must be >= 1")

    def _n_grid(self) -> int:
        """Number of grid steps ABOVE lo that stay <= hi (floor, so a
        misaligned range like [3, 6] step 2 yields {3, 5}, matching the
        reference's suggest_int/randrange semantics — never 6 or 7)."""
        return int((self.hi - self.lo) // self.step)

    # internal (fitting) space: log-transformed for log dims
    def _to_internal(self, x: float) -> float:
        return math.log(x) if self.log else float(x)

    def _from_internal(self, z: float) -> float:
        x = math.exp(z) if self.log else z
        if self.integer:
            # clamp onto the grid, not just into [lo, hi]: plain clamping
            # after rounding can land off-grid at a misaligned hi (e.g.
            # kernel 6 from a [3, 6] step-2 range)
            k = min(max(round((x - self.lo) / self.step), 0), self._n_grid())
            return self.lo + k * self.step
        return min(max(x, self.lo), self.hi)

    def _bounds(self) -> Tuple[float, float]:
        return (self._to_internal(self.lo), self._to_internal(self.hi))

    def random(self, rng: pyrandom.Random) -> float:
        if self.integer:
            # exact-uniform over the grid (matches the reference's
            # suggest_int; continuous-then-round would half-weight the ends)
            return self.lo + self.step * rng.randint(0, self._n_grid())
        lo, hi = self._bounds()
        return self._from_internal(rng.uniform(lo, hi))


def _norm_logpdf(x: float, mu: float, sigma: float) -> float:
    z = (x - mu) / sigma
    return -0.5 * z * z - math.log(sigma * math.sqrt(2.0 * math.pi))


class _Parzen:
    """1-D adaptive Parzen mixture over [lo, hi] with a uniform prior
    component (weight 1/(n+1)) — Bergstra & Bengio (2011)'s estimator, the
    same family Optuna's TPE uses."""

    def __init__(self, points: Sequence[float], lo: float, hi: float):
        self.lo, self.hi = lo, hi
        self.width = max(hi - lo, 1e-12)
        pts = sorted(points)
        # adaptive bandwidth: distance to the farther neighbour, clipped to
        # [width / min(100, n+1), width]
        sigmas = []
        min_sigma = self.width / min(100.0, len(pts) + 1.0)
        for i, p in enumerate(pts):
            left = pts[i] - pts[i - 1] if i > 0 else self.width
            right = pts[i + 1] - pts[i] if i + 1 < len(pts) else self.width
            sigmas.append(min(max(max(left, right), min_sigma), self.width))
        self.points = pts
        self.sigmas = sigmas
        # uniform prior + equal-weight kernels
        self.w_prior = 1.0 / (len(pts) + 1.0)
        self.w_kernel = (1.0 - self.w_prior) / max(len(pts), 1)

    def logpdf(self, x: float) -> float:
        acc = self.w_prior / self.width
        for mu, sigma in zip(self.points, self.sigmas):
            acc += self.w_kernel * math.exp(_norm_logpdf(x, mu, sigma))
        return math.log(max(acc, 1e-300))

    def sample(self, rng: pyrandom.Random) -> float:
        if rng.random() < self.w_prior or not self.points:
            return rng.uniform(self.lo, self.hi)
        i = rng.randrange(len(self.points))
        # truncate into [lo, hi] by redraw-then-clamp
        for _ in range(8):
            x = rng.gauss(self.points[i], self.sigmas[i])
            if self.lo <= x <= self.hi:
                return x
        return min(max(x, self.lo), self.hi)


class TPESampler:
    """Independent-Parzen TPE over a fixed parameter space.

    ``suggest(trial_idx, history)`` -> params dict. ``history`` is a
    sequence of ``(params, value)`` for finished trials in recording order;
    non-finite values (pruned trials) are ignored for the fit, matching the
    reference pruner contract where pruned trials contribute no final value
    (train_diffusion.py records them with value NaN).
    """

    def __init__(self, space: Sequence[Dim], *, seed: int = 2024,
                 gamma: float = 0.25, n_candidates: int = 24,
                 n_startup_trials: int = 10):
        names = [d.name for d in space]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate dim names: {names}")
        self.space = list(space)
        self.seed = seed
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.n_startup_trials = n_startup_trials

    def _rng(self, trial_idx: int) -> pyrandom.Random:
        # string seeds hash via sha512 — stable across Python versions
        return pyrandom.Random(f"tpe:{self.seed}:{int(trial_idx)}")

    def suggest(self, trial_idx: int,
                history: Sequence[Tuple[Dict[str, float], float]]
                ) -> Dict[str, float]:
        rng = self._rng(trial_idx)
        obs = [(p, v) for p, v in history if v == v and math.isfinite(v)]
        # startup counts FINITE finished trials, matching Optuna's
        # n_startup_trials=10-completed semantics: with many pruned/NaN
        # trials, gating on raw trial_idx would start fitting on as few as
        # 2 observations. Still pure in (seed, trial_idx, history).
        if len(obs) < max(self.n_startup_trials, 2):
            return {d.name: d.random(rng) for d in self.space}

        obs.sort(key=lambda pv: pv[1])
        n_good = max(1, math.ceil(self.gamma * len(obs)))
        good, bad = obs[:n_good], obs[n_good:] or obs[-1:]

        out: Dict[str, float] = {}
        for d in self.space:
            lo, hi = d._bounds()
            l_est = _Parzen([d._to_internal(p[d.name]) for p, _ in good],
                            lo, hi)
            g_est = _Parzen([d._to_internal(p[d.name]) for p, _ in bad],
                            lo, hi)
            best_x, best_score = None, -math.inf
            for _ in range(self.n_candidates):
                x = l_est.sample(rng)
                score = l_est.logpdf(x) - g_est.logpdf(x)
                if score > best_score:
                    best_x, best_score = x, score
            out[d.name] = d._from_internal(best_x)
        return out


class RandomSampler:
    """Log-uniform random search behind the same ``suggest`` interface
    (``--search-algo random``)."""

    def __init__(self, space: Sequence[Dim], *, seed: int = 2024):
        self._tpe = TPESampler(space, seed=seed,
                               n_startup_trials=1 << 62)

    def suggest(self, trial_idx, history):
        return self._tpe.suggest(trial_idx, history)


def diffusion_search_space(args) -> List[Dim]:
    """The reference study's 4-dim space (train.py:285-296): batch size,
    odd kernel, UNet level count, log-uniform learning rate."""
    return [
        Dim("batch_size", *args.range_batch_size, integer=True),
        Dim("kernel_size", *args.range_kernel_size, integer=True, step=2),
        Dim("levels", *args.range_level, integer=True),
        Dim("learning_rate", *args.range_learning_rate, log=True),
    ]

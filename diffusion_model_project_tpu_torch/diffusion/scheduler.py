"""DDPM/DDIM noise scheduler (counterpart of the JAX ``diffusion/scheduler.py``).

Linear betas 1e-4 -> 0.02 over T, tables computed in float64 with numpy and
stored as float32 buffers (state-dict keys ``scheduler.<table>``); posterior
variance clamped >= 1e-20; sqrt(alpha_bar) clamped >= 1e-8 in the x0
prediction; ``p_sample`` clips x0 and adds no noise at t=0; ``ddim_sample``
is the eta-parameterized DDIM step with alpha_bar_prev = 1 at t_prev < 0.
All step functions take explicit noise. ``dpm_solver_coefficients`` gives
the per-step coefficients of DPM-Solver++ on the host.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

TABLES = (
    "betas", "alphas", "alphas_cumprod", "alphas_cumprod_prev",
    "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
    "posterior_variance", "posterior_log_variance",
    "posterior_mean_coef1", "posterior_mean_coef2",
)


def linear_alphas_cumprod_f64(num_timesteps: int, beta_start: float = 1e-4,
                              beta_end: float = 0.02) -> np.ndarray:
    betas = np.linspace(beta_start, beta_end, num_timesteps, dtype=np.float64)
    return np.cumprod(1.0 - betas)


def schedule_tables(num_timesteps: int = 1000, beta_start: float = 1e-4,
                    beta_end: float = 0.02) -> dict:
    """The scheduler tables as float32 numpy arrays (computed in float64)."""
    betas = np.linspace(beta_start, beta_end, num_timesteps, dtype=np.float64)
    alphas = 1.0 - betas
    ac = linear_alphas_cumprod_f64(num_timesteps, beta_start, beta_end)
    ac_prev = np.concatenate([[1.0], ac[:-1]])
    post_var = np.clip(betas * (1.0 - ac_prev) / (1.0 - ac), 1e-20, None)
    tables = dict(
        betas=betas, alphas=alphas, alphas_cumprod=ac, alphas_cumprod_prev=ac_prev,
        sqrt_alphas_cumprod=np.sqrt(ac), sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - ac),
        posterior_variance=post_var, posterior_log_variance=np.log(post_var),
        posterior_mean_coef1=betas * np.sqrt(ac_prev) / (1.0 - ac),
        posterior_mean_coef2=(1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac),
    )
    return {k: v.astype(np.float32) for k, v in tables.items()}


def ddim_timesteps(num_timesteps: int, num_steps: int) -> np.ndarray:
    """torch.linspace(T-1, 0, num_steps).long() on the CPU, reproduced exactly
    (first half start + i*step, second half end - (n-1-i)*step, in float64)."""
    n = num_steps
    if n == 1:
        return np.array([num_timesteps - 1], dtype=np.int64)
    start, end = float(num_timesteps - 1), 0.0
    step = (end - start) / (n - 1)
    i = np.arange(n)
    vals = np.where(i < n // 2, start + i * step, end - (n - 1 - i) * step)
    return vals.astype(np.int64)


def dpm_solver_coefficients(alphas_cumprod, ts, order: int = 2) -> dict:
    """Per-step coefficients of multistep DPM-Solver++ (Lu et al. 2022,
    arXiv:2211.01095, data prediction), computed on the host in float64 from
    the float32 ``alphas_cumprod`` table and returned as float32 numpy arrays
    (the JAX package computes the same formulas in float32).

    The solver moves along the strictly decreasing nodes ``ts`` plus a final
    node at alpha_bar = 1. In log-SNR lambda = log(alpha/sigma), the step
    from node i to i+1 is
        x_{i+1} = (sigma_{i+1}/sigma_i) x_i - alpha_{i+1} expm1(-h_i) D_i,
    h_i = lambda_{i+1} - lambda_i, D_i the x0 prediction, extrapolated by
    c2 = h_i / (2 h_{i-1}) at order 2 except on the first and last steps.
    Returns t, alpha_cur, sigma_cur, sigma_ratio, x0_coef and c2, each of
    length len(ts)."""
    if order not in (1, 2):
        raise ValueError(f"DPM-Solver++ order must be 1 or 2, got {order}")
    ts = np.asarray(ts, np.int64)
    if len(ts) > 1 and not np.all(np.diff(ts) < 0):
        raise ValueError(f"DPM timesteps must be strictly decreasing, got {ts}")
    if isinstance(alphas_cumprod, torch.Tensor):
        alphas_cumprod = alphas_cumprod.detach().cpu().numpy()
    abar = np.asarray(alphas_cumprod, np.float32)[ts].astype(np.float64)
    alpha = np.concatenate([np.sqrt(abar), [1.0]])
    sigma = np.concatenate([np.sqrt(1.0 - abar), [0.0]])
    with np.errstate(divide="ignore"):
        lam = np.log(alpha) - np.log(sigma)          # +inf at the final node
    h = np.diff(lam)
    x0_coef = -alpha[1:] * np.expm1(-h)               # 1 at the final node
    sigma_ratio = sigma[1:] / np.maximum(sigma[:-1], 1e-20)
    n = len(ts)
    c2 = np.zeros(n)
    if order == 2 and n > 2:
        h_prev = np.roll(h, 1)
        mid = slice(1, n - 1)
        c2[mid] = np.where(np.isfinite(h[mid]) & (h_prev[mid] > 0),
                           h[mid] / (2.0 * h_prev[mid]), 0.0)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(t=ts, alpha_cur=f32(alpha[:-1]), sigma_cur=f32(sigma[:-1]),
                sigma_ratio=f32(sigma_ratio), x0_coef=f32(x0_coef), c2=f32(c2))


def _bcast(table_t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-sample (N,) gather to x's rank."""
    return table_t.reshape(table_t.shape + (1,) * (x.ndim - table_t.ndim))


class DiffusionScheduler(nn.Module):
    def __init__(self, num_timesteps: int = 1000, beta_start: float = 1e-4,
                 beta_end: float = 0.02):
        super().__init__()
        self.num_timesteps = num_timesteps
        for name, table in schedule_tables(num_timesteps, beta_start, beta_end).items():
            self.register_buffer(name, torch.from_numpy(table))

    def _at(self, name: str, t, x: torch.Tensor) -> torch.Tensor:
        t = torch.as_tensor(t, device=x.device)
        return _bcast(getattr(self, name)[t], x)

    def q_sample(self, x_start, t, noise):
        """q(x_t | x_0) = sqrt(a_bar_t) x_0 + sqrt(1 - a_bar_t) eps."""
        return (self._at("sqrt_alphas_cumprod", t, x_start) * x_start
                + self._at("sqrt_one_minus_alphas_cumprod", t, x_start) * noise)

    def predict_x0_from_noise(self, x_t, t, noise):
        sac = torch.clamp(self._at("sqrt_alphas_cumprod", t, x_t), min=1e-8)
        somac = self._at("sqrt_one_minus_alphas_cumprod", t, x_t)
        return (x_t - somac * noise) / sac

    def q_posterior_mean_variance(self, x_0, x_t, t):
        c1 = self._at("posterior_mean_coef1", t, x_0)
        c2 = self._at("posterior_mean_coef2", t, x_0)
        return c1 * x_0 + c2 * x_t, self._at("posterior_variance", t, x_0)

    def p_sample(self, model_output, x_t, t, noise, clip_denoised: bool = True,
                 clip_range: Tuple[float, float] = (-20.0, 20.0)):
        """One DDPM ancestral step; ``noise`` is masked out where t == 0."""
        x0_pred = self.predict_x0_from_noise(x_t, t, model_output)
        if clip_denoised:
            x0_pred = torch.clamp(x0_pred, clip_range[0], clip_range[1])
        mean, var = self.q_posterior_mean_variance(x0_pred, x_t, t)
        t = torch.as_tensor(t, device=x_t.device)
        nonzero = _bcast((t != 0).to(x_t.dtype), x_t)
        return mean + nonzero * torch.sqrt(var) * noise

    def ddim_sample(self, model_output, x_t, t, t_prev, eta: float = 0.0,
                    noise: Optional[torch.Tensor] = None,
                    clip_range: Tuple[float, float] = (-30.0, 30.0)):
        """One DDIM step from t to t_prev (t_prev < 0 means 'to x_0')."""
        alpha_bar_t = self._at("alphas_cumprod", t, x_t)
        if isinstance(t_prev, int):
            # a fill on the device, of shape (1,): a tensor copied from the
            # host, or a table indexed with a 0-dim tensor (read back as a
            # Python int), would wait for every kernel queued before it
            t_prev = torch.full((1,), t_prev, dtype=torch.int64, device=x_t.device)
        else:
            t_prev = torch.as_tensor(t_prev, device=x_t.device)
        alpha_bar_prev = torch.where(
            _bcast(t_prev, x_t) >= 0,
            self._at("alphas_cumprod", torch.clamp(t_prev, min=0), x_t),
            torch.ones_like(alpha_bar_t))
        x0_pred = torch.clamp(self.predict_x0_from_noise(x_t, t, model_output),
                              clip_range[0], clip_range[1])
        sigma_t = eta * torch.sqrt(
            (1 - alpha_bar_prev) / (1 - alpha_bar_t) * (1 - alpha_bar_t / alpha_bar_prev))
        pred_dir = torch.sqrt(1 - alpha_bar_prev - sigma_t ** 2) * model_output
        x_prev = torch.sqrt(alpha_bar_prev) * x0_pred + pred_dir
        if eta > 0:
            if noise is None:
                raise ValueError("eta > 0 requires explicit noise")
            t = torch.as_tensor(t, device=x_t.device)
            nonzero = _bcast((t > 0).to(x_t.dtype), x_t)
            x_prev = x_prev + nonzero * sigma_t * noise
        return x_prev

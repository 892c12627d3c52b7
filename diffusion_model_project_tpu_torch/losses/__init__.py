"""Losses of the port: the noise-space and VAE cost functions
(``metrics.py``) and the end-to-end evaluation metrics (``eval_metrics.py``).
The physics losses of the JAX package's ``losses/physics.py`` are not ported
yet."""
from .metrics import (
    cost_function,
    divergence_loss,
    huber_loss,
    kl_divergence,
    kl_divergence_sum,
    mae_loss,
    mae_loss_per_channel,
    mae_loss_per_component,
    mse_loss,
    mse_loss_per_component,
    normalized_mae_loss,
    normalized_mae_loss_per_channel,
    normalized_mae_loss_per_component,
    normalized_mse_loss,
    normalized_mse_loss_per_component,
    normalized_mse_per_channel,
)

__all__ = [
    "cost_function", "divergence_loss", "huber_loss", "kl_divergence", "kl_divergence_sum",
    "mae_loss", "mae_loss_per_channel", "mae_loss_per_component", "mse_loss",
    "mse_loss_per_component", "normalized_mae_loss", "normalized_mae_loss_per_channel",
    "normalized_mae_loss_per_component", "normalized_mse_loss",
    "normalized_mse_loss_per_component", "normalized_mse_per_channel",
]

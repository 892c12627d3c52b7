"""Losses of the port: the noise-space and VAE cost functions
(``metrics.py``), the physics losses and metrics (``physics.py``) and the
end-to-end evaluation metrics (``eval_metrics.py``)."""
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
from .physics import (
    PhysicsLoss,
    component_weighted_velocity_loss,
    compute_per_component_metrics,
    compute_physics_metrics,
    divergence_loss_masked,
    flow_rate_consistency_loss,
    laplacian_smoothness_loss,
    no_slip_loss,
    reconstruct_velocity_from_noise_pred,
    smoothness_loss,
)

__all__ = [
    "cost_function", "divergence_loss", "huber_loss", "kl_divergence", "kl_divergence_sum",
    "mae_loss", "mae_loss_per_channel", "mae_loss_per_component", "mse_loss",
    "mse_loss_per_component", "normalized_mae_loss", "normalized_mae_loss_per_channel",
    "normalized_mae_loss_per_component", "normalized_mse_loss",
    "normalized_mse_loss_per_component", "normalized_mse_per_channel",
    "PhysicsLoss", "component_weighted_velocity_loss", "compute_per_component_metrics",
    "compute_physics_metrics", "divergence_loss_masked", "flow_rate_consistency_loss",
    "laplacian_smoothness_loss", "no_slip_loss", "reconstruct_velocity_from_noise_pred",
    "smoothness_loss",
]

"""The validation step of the reference hot loop (helper.py:464-552; the
port's copy of ``make_diffusion_eval_step`` of the JAX package's
``training/steps.py``): encode the target with the frozen E3D, draw one
timestep for each latent slice, q_sample, predict the noise with the UNet
and take the noise-space cost. The physics diagnostics
(``with_physics_metrics``) wait for the port of ``losses/physics.py``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..losses.metrics import cost_function


def make_diffusion_eval_step(*, cost_name: str = "normalized_mse_loss_per_component"
                             ) -> Callable:
    """``eval_step(predictor, batch, generator=None, *, noise=None, t=None)``
    -> ``{"val_loss": 0-d tensor}``. ``batch``: 'img' (B,S,1,H,W), 'U_2d'
    and 'U' (B,S,3,H,W), tensors or arrays. The noise and the timesteps come
    from ``noise`` / ``t`` where given, else from ``generator`` (noise first,
    then t, as the JAX step splits its key)."""
    cost = cost_function(cost_name)

    @torch.no_grad()
    def eval_step(predictor, batch: Dict, generator: Optional[torch.Generator] = None, *,
                  noise: Optional[torch.Tensor] = None,
                  t: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        dev = predictor.device
        img, v2d, v3d = (torch.as_tensor(batch[k]).to(dev, torch.float32)
                         for k in ("img", "U_2d", "U"))
        x_start = predictor.encode_target(v3d)
        eps_pred, noise, _, _ = predictor.forward(img, v2d, x_start, noise=noise, t=t,
                                                  generator=generator)
        return {"val_loss": cost(eps_pred, noise)}

    return eval_step

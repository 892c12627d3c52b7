"""Reference-semantics gradient accumulation with norm clipping (the port's
copy of the JAX package's ``training/accum.py``).

The reference VAE trainers divide the loss by the fixed accumulation count,
``backward()`` into the persistent ``.grad`` buffers, and call
``torch.nn.utils.clip_grad_norm_(params, max_norm=1.0)`` after EVERY
backward: the clip acts on the running accumulated gradient, not on each
microbatch's gradient (reference VAE_model/train_3d_vae_only.py:435-442,
train_2d_with_cross.py:455-459). The optimizer step then applies the
accumulated (pre-divided, clipped) gradient with no count rescale, the
end-of-epoch remainder step included.
"""
from __future__ import annotations

from typing import List, Sequence

import torch


def accumulate_clipped(g_acc: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                       keep, accum_steps: int, max_norm: float = 1.0) -> List[torch.Tensor]:
    """One reference microbatch: ``g_acc <- clip(g_acc + grads / accum_steps)``.

    ``keep`` is a bool or a 0-d bool tensor (it may stay on the device);
    False replays the reference's skip-batch ``continue``: ``g_acc`` comes
    back unchanged and NOT re-clipped. The clip coefficient is
    ``clip_grad_norm_``'s, ``max_norm / (total_norm + 1e-6)``, applied only
    when below 1. Returns the new buffers."""
    keep = torch.as_tensor(keep, dtype=torch.bool, device=g_acc[0].device)
    # torch.where, NOT keep * g: a batch is skipped because its gradients are
    # not finite, and 0 * NaN = NaN would poison g_acc for good
    g_sum = [torch.where(keep, a + g / accum_steps, a) for a, g in zip(g_acc, grads)]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g_sum)))
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    torch._foreach_mul_(g_sum, torch.where(keep, coef, torch.ones_like(coef)))
    return g_sum

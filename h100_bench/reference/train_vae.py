"""Plain reference of the stage-1 VAE training step (E3D + D3D).

A microbatch: mu, logvar = E3D(x); logvar clamped to [-10, 10];
z = mu + exp(logvar / 2) * noise; recon = D3D(z); loss = the per-channel
normalized MAE of (recon * mask, x * mask) (mean |diff| over space over mean
|target| over space, + 1e-8, averaged over channels, then over samples) +
kl_coeff * the mean-form KL. Gradients accumulate as the reference
trainer's do: g_acc <- clip(g_acc + g / accum) after every microbatch,
clip = min(1, max_norm / (||g_acc|| + 1e-6)); a microbatch with a non-finite
mu or logvar is skipped. Every ``accum`` microbatches Adam (bias-corrected,
no weight decay) applies g_acc, which is then zeroed. Written out here, not
taken from torch.optim.

``dtype`` float32 runs as the configuration states: convolutions in TF32
where it says ``tf32_convs``, matmuls in full float32. bfloat16 runs the
forward and backward under bfloat16 autocast (the control: the nearest
precision below the configuration's).
"""
from __future__ import annotations

import contextlib

import torch

from . import nets
from .sampler import nets_prefix, strict_float32


def loss_fn(p: dict, cfg: dict, batch: dict, noise: torch.Tensor, dtype=torch.float32,
            fault: str = ""):
    """(loss, bad): ``fault`` 'half_batch' takes the loss over the first half
    of the batch only (a planted fault for the check's own test)."""
    v, tr = cfg["vae"], cfg["train"]
    x, mask = batch["velocity"], batch["microstructure"]
    if fault == "half_batch":
        k = x.shape[0] // 2
        x, mask, noise = x[:k], mask[:k], noise[:k]
    ctx = (torch.autocast("cuda" if x.is_cuda else "cpu", dtype=dtype)
           if dtype != torch.float32 else contextlib.nullcontext())
    with ctx:
        mu, logvar = nets.encoder(nets_prefix(p, "encoder_3d."), v, x, remat=tr["remat"])
        mu, logvar = mu.float(), logvar.float()
        logvar = logvar.clamp(*tr["logvar_clamp"])
        z = mu + torch.exp(0.5 * logvar) * noise
        recon = nets.decoder(nets_prefix(p, "decoder_3d."), v, z, remat=tr["remat"]).float()
    out, tgt = recon * mask * mask, x * mask * mask   # masked before the loss and inside it
    dims = (-3, -2, -1)
    mae = (out - tgt).abs().mean(dim=dims)
    norm = tgt.abs().mean(dim=dims)
    recons = (mae / (norm + 1e-8)).mean(dim=-1).mean()
    kl = -0.5 * torch.mean(1 + logvar - mu.square() - logvar.exp())
    bad = ~(torch.isfinite(mu).all() & torch.isfinite(logvar).all())
    return recons + tr["kl_coeff"] * kl, bad


def train(weights: dict, cfg: dict, batches, noises, dtype=torch.float32, fault: str = "") -> dict:
    """Run the microbatches ``batches`` (with ``noises``) from ``weights``:
    {'losses': [float], 'first_grad': {name: tensor} (the gradient the first
    Adam step applied), 'params': {name: tensor} (after the last step),
    'steps': optimizer steps taken}."""
    tr = cfg["train"]
    accum, lr, clip = tr["grad_accum"], tr["learning_rate"], tr["clip_norm"]
    b1, b2 = tr["adam_betas"]
    eps = tr["adam_eps"]
    names = list(weights)
    p = {k: w.detach().clone().requires_grad_(True) for k, w in weights.items()}
    m = {k: torch.zeros_like(w) for k, w in p.items()}
    v = {k: torch.zeros_like(w) for k, w in p.items()}
    g_acc = {k: torch.zeros_like(w) for k, w in p.items()}
    out = {"losses": [], "first_grad": None, "steps": 0}
    guard = (strict_float32(cfg["tf32_convs"]) if dtype == torch.float32
             else contextlib.nullcontext())
    with guard:
        for i, (batch, noise) in enumerate(zip(batches, noises)):
            loss, bad = loss_fn(p, cfg, batch, noise, dtype, fault)
            grads = torch.autograd.grad(loss, [p[k] for k in names], allow_unused=True)
            out["losses"].append(float(loss.detach()))
            if not bool(bad):
                with torch.no_grad():
                    for k, g in zip(names, grads):
                        if g is not None:
                            g_acc[k] += g / accum
                    norm = torch.linalg.vector_norm(
                        torch.stack([torch.linalg.vector_norm(g) for g in g_acc.values()]))
                    coef = torch.clamp(clip / (norm + 1e-6), max=1.0)
                    for g in g_acc.values():
                        g.mul_(coef)
            if (i + 1) % accum == 0 and not bool(bad):
                out["steps"] += 1
                t = out["steps"]
                with torch.no_grad():
                    if t == 1:
                        out["first_grad"] = {k: g.clone() for k, g in g_acc.items()}
                    for k in names:
                        g = g_acc[k]
                        m[k].mul_(b1).add_(g, alpha=1 - b1)
                        v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                        mhat = m[k] / (1 - b1 ** t)
                        vhat = v[k] / (1 - b2 ** t)
                        p[k].sub_(lr * mhat / (vhat.sqrt() + eps))
                        g.zero_()
    out["params"] = {k: w.detach() for k, w in p.items()}
    return out

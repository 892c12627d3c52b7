"""The system under test: the port's objects, built from a configuration file and
the benchmark's weights. The only module of the harness that imports the port."""
from __future__ import annotations

import torch


def load(module: torch.nn.Module, weights: dict, prefix: str = "") -> None:
    """Copy ``weights`` (names as the state dict has them) into ``module``."""
    sd = module.state_dict()
    missing = sorted(k for k in weights if prefix + k not in sd)
    if missing:
        raise KeyError(f"the port has no parameters named {missing[:5]}")
    with torch.no_grad():
        for k, v in weights.items():
            dst = sd[prefix + k]
            if dst.shape != v.shape:
                raise ValueError(f"{k}: the port's shape {tuple(dst.shape)} != {tuple(v.shape)}")
            dst.copy_(v)


def predictor(cfg: dict, weights: dict, device):
    """The frozen ``LatentDiffusionPredictor`` of a configuration."""
    from diffusion_model_project_tpu_torch.diffusion.predictor import LatentDiffusionPredictor

    v = cfg["vae"]
    pred = LatentDiffusionPredictor(
        dict(cfg["unet"]), num_timesteps=cfg["num_timesteps"],
        distance_transform=cfg["distance_transform"], latent_channels=v["latent_channels"],
        vae_features=tuple(v["features"]), compute_dtype=getattr(torch, cfg["compute_dtype"]),
        device=device)
    load(pred, weights)
    pred.set_normalizer(cfg["normalizer"])
    return pred.requires_grad_(False).eval()


def int8(pred):
    """The port's own int8 path, both flags: the control of the sampler cells."""
    return pred.with_vae_int8().with_unet_int8()


def sampler_fn(pred, sampler: str, steps: int, order: int = 2):
    """fn(img, v2d, noise) -> (B,S,3,H,W): one call of the port's sampler."""
    if sampler == "ddim":
        return lambda img, v2d, noise: pred.predict_ddim(img, v2d, num_steps=steps, eta=0.0,
                                                         noise=noise)
    if sampler == "dpm":
        return lambda img, v2d, noise: pred.predict_dpm(img, v2d, num_steps=steps, order=order,
                                                        noise=noise)
    raise ValueError(f"unknown sampler {sampler!r}")


def unet_modules(pred) -> dict:
    """The modules the sampler cells' spans hook, by span name."""
    return {"unet": pred.model, "vae.encode_2d": pred.vae.encoder_2d,
            "vae.decode_3d": pred.vae.decoder_3d}


def kernel_modules(module) -> tuple:
    """(GroupNorm modules, self-attention modules) of the port inside ``module``."""
    from diffusion_model_project_tpu_torch.models.layers import GroupNorm, MultiheadSelfAttention

    gn = [m for m in module.modules() if isinstance(m, GroupNorm)]
    attn = [m for m in module.modules() if isinstance(m, MultiheadSelfAttention)]
    return gn, attn


def launches() -> dict:
    """The port's launch counters of K1 and K2."""
    from diffusion_model_project_tpu_torch.ops.cuda import attention, groupnorm_act

    return {"k1": groupnorm_act.LAUNCHES, "k2": attention.LAUNCHES}


def k1_kernels_a_call(x, groups: int, act: str):
    """Kernels one K1 call launches, from the port's planner (None if it has none)."""
    from diffusion_model_project_tpu_torch.ops.cuda import groupnorm_act

    plan = getattr(groupnorm_act, "launch_plan", None)
    return None if plan is None else plan(x, groups, act).kernels


def server(pred, wl: dict, shape: tuple):
    from diffusion_model_project_tpu_torch.utils.serving import InferenceServer

    return InferenceServer(pred, sampler=wl["sampler"], num_steps=wl["steps"],
                           batch_sizes=tuple(wl["ladder"]), max_wait_ms=wl["max_wait_ms"],
                           max_pending=wl["max_pending"], expected_shape=shape)


def http_server(srv):
    from diffusion_model_project_tpu_torch.utils.serving import build_http_server

    return build_http_server(srv, host="127.0.0.1", port=0)


def stage1(cfg: dict, weights: dict, device):
    """(vae, optimizer, train_step) of the port's stage-1 trainer."""
    from diffusion_model_project_tpu_torch.training.train_vae_stage1 import (AccumAdam, Stage1VAE,
                                                                             make_steps)

    v, tr = cfg["vae"], cfg["train"]
    with torch.device(device):
        vae = Stage1VAE(v["in_channels"], v["latent_channels"], remat=tr["remat"],
                        features=tuple(v["features"]))
    load(vae, weights)
    opt = AccumAdam(vae, tr["learning_rate"])
    train_step, _, _ = make_steps(vae, tr["loss"], opt, accum_steps=tr["grad_accum"])
    return vae, opt, train_step

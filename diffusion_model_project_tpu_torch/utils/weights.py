"""Carry weights from the JAX package's flax param trees into the port.

The port's own copy of the layout transforms in the JAX package's
``utils/torch_export.py`` (``export_unet``, ``export_dual_vae``,
``export_predictor_parts``). Input: nested dicts of numpy arrays (flax
params, channels-last). Output: state dicts whose keys are the reference
torch predictor's, which the port's modules use, so
``load_state_dict(..., strict=True)`` accepts them.

  Conv3d  (kD, kH, kW, I, O) -> (O, I, kD, kH, kW)
  Conv2d  (kH, kW, I, O)     -> (O, I, kH, kW)
  ConvT2d                     unchanged (already torch (I, O, kH, kW))
  Linear  (I, O)             -> (O, I)
  MHA in_proj_weight (E, 3E) -> (3E, E); proj_out (C, C) -> Conv1d (C, C, 1)
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..diffusion.scheduler import TABLES

StateDict = Dict[str, np.ndarray]


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _linear_w(w) -> np.ndarray:
    return np.transpose(_a(w), (1, 0))


def _conv(params: dict, key: str, sd: StateDict, *, transpose2d: bool = False) -> None:
    w = _a(params["weight"])
    if transpose2d:
        sd[f"{key}.weight"] = w
    elif w.ndim == 5:
        sd[f"{key}.weight"] = np.transpose(w, (4, 3, 0, 1, 2))
    elif w.ndim == 4:
        sd[f"{key}.weight"] = np.transpose(w, (3, 2, 0, 1))
    else:
        raise ValueError(f"Unexpected conv weight rank for {key}: {w.shape}")
    if "bias" in params:
        sd[f"{key}.bias"] = _a(params["bias"])


def _norm(params: dict, key: str, sd: StateDict) -> None:
    sd[f"{key}.weight"] = _a(params["weight"])
    sd[f"{key}.bias"] = _a(params["bias"])


def _linear(params: dict, key: str, sd: StateDict) -> None:
    sd[f"{key}.weight"] = _linear_w(params["weight"])
    if "bias" in params:
        sd[f"{key}.bias"] = _a(params["bias"])


def _res_block(params: dict, key: str, sd: StateDict) -> None:
    if "film1" in params or "film2" in params:
        raise NotImplementedError("conditional (FiLM) VAE weights are not ported yet")
    _norm(params["norm1"], f"{key}.norm1", sd)
    _conv(params["conv1"], f"{key}.conv1", sd)
    _norm(params["norm2"], f"{key}.norm2", sd)
    _conv(params["conv2"], f"{key}.conv2", sd)
    if "residual_layer" in params:
        _conv(params["residual_layer"], f"{key}.residual_layer", sd)


def _vae_half(params: dict, up: bool) -> StateDict:
    sd: StateDict = {}
    _conv(params["conv_in"], "conv_in", sd)
    names = (("res1_1", "res1_2"), ("conv_up1" if up else "down1"),
             ("res2_1", "res2_2"), ("conv_up2" if up else "down2"), ("res3_1", "res3_2"))
    for entry in names:
        if isinstance(entry, tuple):
            for name in entry:
                _res_block(params[name], name, sd)
        else:
            _conv(params[entry], entry, sd)
    _norm(params["norm_out"], "norm_out", sd)
    _conv(params["conv_out"], "conv_out", sd)
    return sd


def export_dual_vae(branches: dict) -> StateDict:
    """{'encoder_2d': params, ...} -> DualBranchVAE state dict (branch-prefixed)."""
    sd: StateDict = {}
    for name, params in branches.items():
        if params is None:
            continue
        for k, v in _vae_half(params, up=name.startswith("decoder")).items():
            sd[f"{name}.{k}"] = v
    return sd


def _double_block(params: dict, key: str, sd: StateDict) -> None:
    _conv(params["block1"]["conv"], f"{key}.block1.conv", sd)
    _norm(params["block1"]["norm"], f"{key}.block1.norm", sd)
    _conv(params["block2"]["conv"], f"{key}.block2.conv", sd)
    _norm(params["block2"]["norm"], f"{key}.block2.norm", sd)
    if "time_mlp_1" in params:
        _linear(params["time_mlp_1"], f"{key}.time_mlp.1", sd)


def _self_attention(params: dict, key: str, sd: StateDict) -> None:
    _norm(params["norm"], f"{key}.norm", sd)
    mha = params["mha"]
    sd[f"{key}.mha.in_proj_weight"] = _linear_w(mha["in_proj_weight"])
    sd[f"{key}.mha.in_proj_bias"] = _a(mha["in_proj_bias"])
    sd[f"{key}.mha.out_proj.weight"] = _linear_w(mha["out_proj_weight"])
    sd[f"{key}.mha.out_proj.bias"] = _a(mha["out_proj_bias"])
    sd[f"{key}.proj_out.weight"] = _linear_w(params["proj_out_weight"])[..., None]
    sd[f"{key}.proj_out.bias"] = _a(params["proj_out_bias"])


def export_unet(params: dict) -> StateDict:
    """Flax UNet params -> UNet state dict (levels inferred from the keys)."""
    sd: StateDict = {}
    if "time_mlp_0" in params:
        _linear(params["time_mlp_0"], "time_mlp.0", sd)
        _linear(params["time_mlp_2"], "time_mlp.2", sd)
    num_levels = sum(1 for k in params if k.startswith("enc") and k.endswith("_conv"))
    for k in range(num_levels):
        _double_block(params[f"enc{k}_conv"], f"encoder.{k}.0", sd)
        if f"enc{k}_attn" in params:
            _self_attention(params[f"enc{k}_attn"], f"encoder.{k}.1", sd)
        _norm(params[f"enc{k}_down"]["norm"], f"encoder.{k}.2.norm", sd)
    _double_block(params["bottleneck"], "bottleneck", sd)
    for k in range(num_levels):
        _conv(params[f"dec{k}_up"]["conv"], f"decoder.{k}.0.conv", sd, transpose2d=True)
        _norm(params[f"dec{k}_up"]["norm"], f"decoder.{k}.0.norm", sd)
        _double_block(params[f"dec{k}_conv"], f"decoder.{k}.1", sd)
        if f"dec{k}_attn" in params:
            _self_attention(params[f"dec{k}_attn"], f"decoder.{k}.2", sd)
    _conv(params["final_conv"], "final_conv", sd)
    return sd


def export_predictor_parts(*, unet_params: dict, vae_params: dict, scheduler,
                           norm_input, norm_output, distance_transform: bool) -> StateDict:
    """The full predictor state dict. ``scheduler``: any object with the ten
    table attributes (the port's or the JAX package's DiffusionScheduler)."""
    sd: StateDict = {}
    for k, v in export_unet(unet_params).items():
        sd[f"model.{k}"] = v
    for k, v in export_dual_vae(vae_params).items():
        sd[f"vae.{k}"] = v
    for name in TABLES:
        table = getattr(scheduler, name)
        if isinstance(table, torch.Tensor):
            table = table.detach().cpu().numpy()
        sd[f"scheduler.{name}"] = _a(table)
    sd["normalizer.input.scale_factors"] = _a(norm_input).reshape(-1)
    sd["normalizer.output.scale_factors"] = _a(norm_output).reshape(-1)
    sd["distance_transform"] = np.asarray([1.0 if distance_transform else 0.0], np.float32)
    return sd


def to_tensors(sd: StateDict) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def load_flax_params(predictor, unet_params: dict, vae_params: dict) -> None:
    """Load flax UNet and VAE params into a port predictor (strict)."""
    predictor.model.load_state_dict(to_tensors(export_unet(unet_params)), strict=True)
    predictor.vae.load_state_dict(to_tensors(export_dual_vae(vae_params)), strict=True)

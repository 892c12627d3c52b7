"""Carry weights between the JAX package's flax param trees and the port.

The port's own copy of the layout transforms in the JAX package's
``utils/torch_export.py`` (``export_unet``, ``export_dual_vae``,
``export_predictor_parts``). Input: nested dicts of numpy arrays (flax
params, channels-last; a bfloat16 leaf read from a msgpack file is a torch
tensor). Output: state dicts whose keys are the reference
torch predictor's, which the port's modules use, so
``load_state_dict(..., strict=True)`` accepts them. Their inverses
(``unet_to_flax``, ``vae_branch_to_flax``, ``dual_vae_to_flax``) give the
flax trees back from the port's state dicts, as views of its tensors, for
the checkpoints the port writes (parameters and Adam moments alike).

  Conv3d  (kD, kH, kW, I, O) -> (O, I, kD, kH, kW)
  Conv2d  (kH, kW, I, O)     -> (O, I, kH, kW)
  ConvT2d                     unchanged (already torch (I, O, kH, kW))
  Linear  (I, O)             -> (O, I)   (also FiLM's mlp_0/2/4 -> mlp.0/2/4)
  MHA in_proj_weight (E, 3E) -> (3E, E); proj_out (C, C) -> Conv1d (C, C, 1)
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..diffusion.scheduler import TABLES

StateDict = Dict[str, np.ndarray]


def _a(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):  # e.g. a bfloat16 leaf of a flax msgpack file
        return x.detach().to(torch.float32).cpu().numpy()
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


def _film(params: dict, key: str, sd: StateDict) -> None:
    for i in (0, 2, 4):
        _linear(params[f"mlp_{i}"], f"{key}.mlp.{i}", sd)


def _res_block(params: dict, key: str, sd: StateDict) -> None:
    _norm(params["norm1"], f"{key}.norm1", sd)
    _conv(params["conv1"], f"{key}.conv1", sd)
    _norm(params["norm2"], f"{key}.norm2", sd)
    _conv(params["conv2"], f"{key}.conv2", sd)
    if "residual_layer" in params:
        _conv(params["residual_layer"], f"{key}.residual_layer", sd)
    for film in ("film1", "film2"):
        if film in params:
            _film(params[film], f"{key}.{film}", sd)


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
    for film in (("film_in", "film_pre_out") if up else ("film_in", "film_out")):
        if film in params:
            _film(params[film], film, sd)
    return sd


def export_vae_branch(name: str, params: dict) -> StateDict:
    """One VAE branch's flax params -> its state dict (keys relative to the
    branch); ``name`` starting with 'decoder' selects the decoder layout."""
    return _vae_half(params, up=name.startswith("decoder"))


def export_dual_vae(branches: dict) -> StateDict:
    """{'encoder_2d': params, ...} -> DualBranchVAE state dict (branch-prefixed)."""
    sd: StateDict = {}
    for name, params in branches.items():
        if params is None:
            continue
        for k, v in export_vae_branch(name, params).items():
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


def export_attention_block(params: dict) -> StateDict:
    """A flax VAE ``AttentionBlock``'s params -> the port's ``AttentionBlock``
    state dict (``norm.*``, ``attention.*``)."""
    sd: StateDict = {}
    _norm(params["norm"], "norm", sd)
    mha = params["attention"]
    sd["attention.in_proj_weight"] = _linear_w(mha["in_proj_weight"])
    sd["attention.in_proj_bias"] = _a(mha["in_proj_bias"])
    sd["attention.out_proj.weight"] = _linear_w(mha["out_proj_weight"])
    sd["attention.out_proj.bias"] = _a(mha["out_proj_bias"])
    return sd


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


def to_tensor(x) -> torch.Tensor:
    """A float32 CPU tensor holding its own copy of ``x``."""
    return torch.from_numpy(np.array(_a(x), dtype=np.float32))


def to_tensors(sd: StateDict) -> Dict[str, torch.Tensor]:
    return {k: to_tensor(v) for k, v in sd.items()}


def load_flax_params(predictor, unet_params: dict, vae_params: dict) -> None:
    """Load flax UNet and VAE params into a port predictor (strict)."""
    predictor.model.load_state_dict(to_tensors(export_unet(unet_params)), strict=True)
    predictor.vae.load_state_dict(to_tensors(export_dual_vae(vae_params)), strict=True)


# ------------------------------------------------ port state dict -> flax tree


def _t(x) -> torch.Tensor:
    return x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _conv_to_flax(sd, key: str, *, transpose2d: bool = False) -> dict:
    w = _t(sd[f"{key}.weight"])
    if not transpose2d:
        if w.ndim == 5:
            w = w.permute(2, 3, 4, 1, 0)          # (O, I, kD, kH, kW) -> (kD, kH, kW, I, O)
        elif w.ndim == 4:
            w = w.permute(2, 3, 1, 0)             # (O, I, kH, kW) -> (kH, kW, I, O)
        else:
            raise ValueError(f"Unexpected conv weight rank for {key}: {tuple(w.shape)}")
    out = {"weight": w}
    if f"{key}.bias" in sd:
        out["bias"] = _t(sd[f"{key}.bias"])
    return out


def _norm_to_flax(sd, key: str) -> dict:
    return {"weight": _t(sd[f"{key}.weight"]), "bias": _t(sd[f"{key}.bias"])}


def _linear_to_flax(sd, key: str) -> dict:
    out = {"weight": _t(sd[f"{key}.weight"]).t()}
    if f"{key}.bias" in sd:
        out["bias"] = _t(sd[f"{key}.bias"])
    return out


def _film_to_flax(sd, key: str) -> dict:
    return {f"mlp_{i}": _linear_to_flax(sd, f"{key}.mlp.{i}") for i in (0, 2, 4)}


def _has(sd, prefix: str) -> bool:
    return any(k.startswith(prefix) for k in sd)


def _res_block_to_flax(sd, key: str) -> dict:
    out = {"norm1": _norm_to_flax(sd, f"{key}.norm1"), "conv1": _conv_to_flax(sd, f"{key}.conv1"),
           "norm2": _norm_to_flax(sd, f"{key}.norm2"), "conv2": _conv_to_flax(sd, f"{key}.conv2")}
    if _has(sd, f"{key}.residual_layer."):
        out["residual_layer"] = _conv_to_flax(sd, f"{key}.residual_layer")
    for film in ("film1", "film2"):
        if _has(sd, f"{key}.{film}."):
            out[film] = _film_to_flax(sd, f"{key}.{film}")
    return out


def vae_branch_to_flax(name: str, sd) -> dict:
    """Inverse of :func:`export_vae_branch`: one branch's state dict (keys
    relative to the branch) -> its flax params."""
    up = name.startswith("decoder")
    out = {"conv_in": _conv_to_flax(sd, "conv_in")}
    for stage in ("res1_1", "res1_2", "res2_1", "res2_2", "res3_1", "res3_2"):
        out[stage] = _res_block_to_flax(sd, stage)
    for conv in (("conv_up1", "conv_up2") if up else ("down1", "down2")):
        out[conv] = _conv_to_flax(sd, conv)
    out["norm_out"] = _norm_to_flax(sd, "norm_out")
    out["conv_out"] = _conv_to_flax(sd, "conv_out")
    for film in (("film_in", "film_pre_out") if up else ("film_in", "film_out")):
        if _has(sd, f"{film}."):
            out[film] = _film_to_flax(sd, film)
    return out


def dual_vae_to_flax(sd) -> dict:
    """Inverse of :func:`export_dual_vae`: a DualBranchVAE state dict
    (branch-prefixed) -> {'encoder_2d': params, ...}."""
    branches = sorted({k.split(".", 1)[0] for k in sd})
    return {name: vae_branch_to_flax(name, {k.split(".", 1)[1]: v for k, v in sd.items()
                                           if k.startswith(name + ".")})
            for name in branches}


def _double_block_to_flax(sd, key: str) -> dict:
    out = {"block1": {"conv": _conv_to_flax(sd, f"{key}.block1.conv"),
                      "norm": _norm_to_flax(sd, f"{key}.block1.norm")},
           "block2": {"conv": _conv_to_flax(sd, f"{key}.block2.conv"),
                      "norm": _norm_to_flax(sd, f"{key}.block2.norm")}}
    if _has(sd, f"{key}.time_mlp.1."):
        out["time_mlp_1"] = _linear_to_flax(sd, f"{key}.time_mlp.1")
    return out


def _self_attention_to_flax(sd, key: str) -> dict:
    return {"norm": _norm_to_flax(sd, f"{key}.norm"),
            "mha": {"in_proj_weight": _t(sd[f"{key}.mha.in_proj_weight"]).t(),
                    "in_proj_bias": _t(sd[f"{key}.mha.in_proj_bias"]),
                    "out_proj_weight": _t(sd[f"{key}.mha.out_proj.weight"]).t(),
                    "out_proj_bias": _t(sd[f"{key}.mha.out_proj.bias"])},
            "proj_out_weight": _t(sd[f"{key}.proj_out.weight"])[..., 0].t(),
            "proj_out_bias": _t(sd[f"{key}.proj_out.bias"])}


def attention_block_to_flax(sd) -> dict:
    """Inverse of :func:`export_attention_block`."""
    return {"norm": _norm_to_flax(sd, "norm"),
            "attention": {"in_proj_weight": _t(sd["attention.in_proj_weight"]).t(),
                          "in_proj_bias": _t(sd["attention.in_proj_bias"]),
                          "out_proj_weight": _t(sd["attention.out_proj.weight"]).t(),
                          "out_proj_bias": _t(sd["attention.out_proj.bias"])}}


def unet_to_flax(sd) -> dict:
    """Inverse of :func:`export_unet`: a UNet state dict -> flax UNet params."""
    out = {}
    if _has(sd, "time_mlp.0."):
        out["time_mlp_0"] = _linear_to_flax(sd, "time_mlp.0")
        out["time_mlp_2"] = _linear_to_flax(sd, "time_mlp.2")
    num_levels = len({k.split(".")[1] for k in sd if k.startswith("encoder.")})
    for k in range(num_levels):
        out[f"enc{k}_conv"] = _double_block_to_flax(sd, f"encoder.{k}.0")
        if _has(sd, f"encoder.{k}.1."):
            out[f"enc{k}_attn"] = _self_attention_to_flax(sd, f"encoder.{k}.1")
        out[f"enc{k}_down"] = {"norm": _norm_to_flax(sd, f"encoder.{k}.2.norm")}
        out[f"dec{k}_up"] = {"conv": _conv_to_flax(sd, f"decoder.{k}.0.conv", transpose2d=True),
                             "norm": _norm_to_flax(sd, f"decoder.{k}.0.norm")}
        out[f"dec{k}_conv"] = _double_block_to_flax(sd, f"decoder.{k}.1")
        if _has(sd, f"decoder.{k}.2."):
            out[f"dec{k}_attn"] = _self_attention_to_flax(sd, f"decoder.{k}.2")
    out["bottleneck"] = _double_block_to_flax(sd, "bottleneck")
    out["final_conv"] = _conv_to_flax(sd, "final_conv")
    return out

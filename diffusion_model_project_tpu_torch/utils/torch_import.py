"""Read reference ``.pt`` checkpoints into the port (the port's own copy of
the read side of the JAX package's ``utils/torch_import.py``).

The port's module names are the reference's, so no layout transform is
needed: a state dict loads as it is, once the legacy ``layers.N`` names of
old VAE checkpoints are mapped to the named layers
(reference Diffusion_model/src/predictor.py:51-122). Tensors stay torch
tensors.
"""
from __future__ import annotations

import os.path as osp
import pickle
from typing import Dict, Optional, Sequence

import torch

StateDict = Dict[str, torch.Tensor]


def load_torch_state_dict(path: str) -> StateDict:
    """A ``.pt`` state dict as {key: CPU tensor}. A file saved as a whole
    module (``torch.save(model)``) cannot be unpickled with
    ``weights_only=True``, so that case retries with ``weights_only=False``
    (the file is trusted as the reference's loaders trust it) and takes the
    module's ``state_dict()``."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:  # the weights-only unpickler refused: a whole module
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().cpu() for k, v in sd.items()}


_ENCODER_LAYER_MAP = {
    "layers.0": "conv_in", "layers.1": "res1_1", "layers.2": "res1_2",
    "layers.3": "down1", "layers.4": "res2_1", "layers.5": "res2_2",
    "layers.6": "down2", "layers.7": "res3_1", "layers.8": "res3_2",
    "layers.9": "norm_out", "layers.11": "conv_out",
}

_DECODER_LAYER_MAP = {
    "layers.0": "conv_in", "layers.1": "res1_1", "layers.2": "res1_2",
    # layers.3 = Upsample (no params)
    "layers.4": "conv_up1", "layers.5": "res2_1", "layers.6": "res2_2",
    # layers.7 = Upsample
    "layers.8": "conv_up2", "layers.9": "res3_1", "layers.10": "res3_2",
    "layers.11": "norm_out",
    # layers.12 = SiLU
    "layers.13": "conv_out",
}


def _apply_layer_map(sd: StateDict, mapping: Dict[str, str]) -> StateDict:
    out = {}
    for key, value in sd.items():
        new_key = key
        for old, new in mapping.items():
            if key.startswith(old + "."):
                new_key = new + key[len(old):]
                break
        out[new_key] = value
    return out


def needs_key_mapping(sd: StateDict) -> bool:
    return any(k.startswith("layers.") for k in sd)


def vae_branch_state_dict(sd: StateDict, decoder: bool) -> StateDict:
    """One encoder's or decoder's state dict (keys relative to it) with the
    legacy ``layers.N`` names mapped to the named layers."""
    if needs_key_mapping(sd):
        sd = _apply_layer_map(sd, _DECODER_LAYER_MAP if decoder else _ENCODER_LAYER_MAP)
    return sd


def detect_vae_checkpoint_type(sd: StateDict) -> Optional[str]:
    """Flavour from the key prefixes (reference predictor.py:396-413)."""
    has_e2d = any(k.startswith("encoder_2d.") for k in sd)
    has_e3d = any(k.startswith("encoder_3d.") for k in sd)
    has_enc = any(k.startswith("encoder.") for k in sd)
    if has_e2d and has_e3d:
        return "dual_full"
    if has_e3d and not has_e2d:
        return "dual_stage1_3d"
    if has_e2d and not has_e3d:
        return "dual_stage2_2d"
    if has_enc:
        return "standard"
    return None


def find_model_file(folder: str,
                    order: Sequence[str] = ("vae.pt", "best_model.pt", "model.pt")) -> str:
    for fname in order:
        candidate = osp.join(folder, fname)
        if osp.exists(candidate):
            return candidate
    raise FileNotFoundError(f"No model file found in {folder}. Looked for: {', '.join(order)}")


def strip_prefix(sd: StateDict, prefix: str) -> StateDict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

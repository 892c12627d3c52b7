"""Load and save run dirs and checkpoints (the port's copy of the JAX
package's ``utils/checkpoint.py``).

Two on-disk formats load:
  - the JAX package's native flax msgpack files (``model.msgpack``,
    ``best_model.msgpack``, ``ema_model.msgpack`` in a diffusion run dir;
    ``vae.msgpack`` / ``best_model.msgpack`` / ``model.msgpack`` in a VAE
    dir), read by ``utils/flax_msgpack.py`` and carried to state dicts by
    ``utils/weights.py``;
  - the reference's ``.pt`` state dicts, whose keys are the port's own.
It replays the reference's conventions (Diffusion_model/src/predictor.py:
342-599): the file-name fallback chains, the VAE flavours ``dual_full`` /
``dual_stage1_3d`` / ``dual_stage2_2d`` / ``standard`` (with
``standard_conditional`` when the checkpoint holds FiLM weights) and split
encoder / decoder dirs, legacy ``layers.N`` names, ``norm_factors`` from the
decoder dir's ``vae_log.json``, and scheduler tables rebuilt, never loaded.
Every load is strict: a missing or unexpected key or a wrong shape raises
``ValueError``.

The save side writes the JAX package's own formats with the port's
msgpack encoder: ``model.msgpack`` / ``best_model.msgpack`` /
``ema_model.msgpack`` (``predictor_state``: the UNet's and the VAE's flax
params, the normalizers) and ``train_state.msgpack`` (the predictor state,
the optimizer state in optax's ``to_state_dict`` layout, the epoch and the
best validation loss), so the JAX package's ``predictor_from_directory`` and
``load_train_state`` read what the port writes, and the reverse. The VAE
trainers' run dirs hold flax trees keyed by branch (``vae_params`` /
``load_vae_params``).
"""
from __future__ import annotations

import json
import os.path as osp
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import flax_msgpack, weights
from . import torch_import as ti
from .async_ckpt import atomic_write, device_snapshot

StateDict = Dict[str, torch.Tensor]
BRANCHES = ("encoder_2d", "encoder_3d", "decoder_2d", "decoder_3d")


# --------------------------------------------------------------------------
# strict structure checks
# --------------------------------------------------------------------------

class _Reads(dict):
    """A flax param tree that records the paths of the leaves read from it."""

    def __init__(self, tree: dict, path: tuple, seen: set):
        super().__init__(tree)
        self._path, self._seen = path, seen

    def __getitem__(self, key):
        path = self._path + (key,)
        if key not in self:
            raise KeyError(".".join(path))
        value = super().__getitem__(key)
        if isinstance(value, dict):
            return _Reads(value, path, self._seen)
        self._seen.add(path)
        return value

    def items(self):
        return [(k, self[k]) for k in self]


def _leaf_paths(tree, path: tuple = ()) -> set:
    if not isinstance(tree, dict):
        return {path}
    return set().union(*(_leaf_paths(v, path + (k,)) for k, v in tree.items()))


def _mismatch(what: str, missing, unexpected) -> ValueError:
    return ValueError(
        f"{what}: state dict does not match the model. "
        f"Missing key(s): {missing[:8]}{'...' if len(missing) > 8 else ''}; "
        f"unexpected key(s): {unexpected[:8]}{'...' if len(unexpected) > 8 else ''}")


def _from_flax(export, tree: dict, what: str) -> StateDict:
    """``export(tree)`` (a ``utils/weights.py`` transform) as tensors; a leaf
    the transform needs and the tree lacks, or a leaf of the tree the
    transform never read, raises."""
    seen: set = set()
    try:
        sd = export(_Reads(tree, (), seen))
    except KeyError as e:
        raise _mismatch(what, [e.args[0]], []) from None
    unread = sorted(".".join(p) for p in _leaf_paths(tree) - seen)
    if unread:
        raise _mismatch(what, [], unread)
    return weights.to_tensors(sd)


def load_strict(module: nn.Module, sd: StateDict, what: str) -> None:
    """``module.load_state_dict(sd, strict=True)``, with missing and
    unexpected keys and shape mismatches raised as ``ValueError`` first."""
    expected = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    missing = sorted(set(expected) - set(got))
    unexpected = sorted(set(got) - set(expected))
    if missing or unexpected:
        raise _mismatch(what, missing, unexpected)
    bad = [f"{k}: expected {expected[k]}, got {got[k]}"
           for k in sorted(expected) if expected[k] != got[k]]
    if bad:
        raise ValueError(
            f"{what}: state dict shapes do not match the model (different "
            f"model-shaping flags?). {'; '.join(bad[:8])}{'...' if len(bad) > 8 else ''}")
    module.load_state_dict(sd, strict=True)


# --------------------------------------------------------------------------
# native msgpack format
# --------------------------------------------------------------------------

def predictor_state(predictor, frozen_vae: Optional[dict] = None,
                    unet_state: Optional[StateDict] = None) -> dict:
    """The serializable predictor tree of a ``model.msgpack``: flax UNet and
    VAE params (views of the live tensors, see ``weights.unet_to_flax``) and
    the normalizers' factors. ``frozen_vae``: a host copy of the VAE's flax
    params (``frozen_vae_params``) spliced in place of the live VAE: the VAE
    is frozen during diffusion training (reference predictor.py:604-607),
    so one copy a run serves every checkpoint. ``unet_state``: a UNet state
    dict to write instead of the model's own (the EMA weights)."""
    unet_state = predictor.model.state_dict() if unet_state is None else unet_state
    return {
        "unet_params": weights.unet_to_flax(unet_state),
        "vae_params": (frozen_vae if frozen_vae is not None
                       else weights.dual_vae_to_flax(predictor.vae.state_dict())),
        "norm_input": predictor.normalizer["input"].scale_factors.detach(),
        "norm_output": predictor.normalizer["output"].scale_factors.detach(),
    }


def host_copy(tree):
    """``tree`` with every (float32) tensor leaf as a C-ordered numpy copy."""
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    return tree.detach().cpu().contiguous().numpy().copy()


def frozen_vae_params(predictor) -> dict:
    """A host copy of the predictor's VAE as flax params, for ``frozen_vae``."""
    return host_copy(weights.dual_vae_to_flax(predictor.vae.state_dict()))


def save_tree(path: str, tree, writer=None) -> None:
    """Write ``tree`` as flax msgpack to ``path`` atomically, now or through
    an ``AsyncCheckpointWriter`` (from a device copy taken before this
    returns)."""
    if writer is None:
        atomic_write(path, flax_msgpack.msgpack_serialize(tree))
        return
    # a copy on the device before submit returns: the next optimizer step
    # updates the parameters, moments and EMA in place
    writer.submit(path, device_snapshot(tree))


def save_predictor(predictor, path: str, writer=None, frozen_vae: Optional[dict] = None,
                   unet_state: Optional[StateDict] = None) -> None:
    """Write ``predictor_state`` to ``path`` (flax msgpack), atomically; with
    an ``AsyncCheckpointWriter`` the host copy, serialization and write run
    on its thread, from a snapshot taken here."""
    save_tree(path, predictor_state(predictor, frozen_vae, unet_state), writer)


def save_train_state(path: str, predictor, optimizer, epoch: int, best_loss: float,
                     writer=None, frozen_vae: Optional[dict] = None) -> None:
    """The full training state (weights, optimizer, progress) for resume, in
    the JAX package's ``train_state.msgpack`` layout: ``optimizer`` (a
    ``training.train_diffusion.make_optimizer`` optimizer) writes its state in
    optax's ``to_state_dict`` layout."""
    state = {
        "predictor": predictor_state(predictor, frozen_vae),
        "opt_state": optimizer.state_tree(),
        "epoch": np.asarray(epoch, np.int64),
        "best_loss": np.asarray(best_loss, np.float64),
    }
    save_tree(path, state, writer)


def _load_predictor_tree(predictor, state: dict, path: str):
    load_strict(predictor.model, _from_flax(weights.export_unet, state["unet_params"],
                                            f"unet_params from {path}"),
                f"unet_params from {path}")
    # a conditional VAE's film_* leaves in a tree meant for the plain VAE
    # (or the reverse) would change what the VAE computes: strict here too
    load_strict(predictor.vae, _from_flax(weights.export_dual_vae, state["vae_params"],
                                          f"vae_params from {path}"),
                f"vae_params from {path}")
    return predictor.set_normalizer({"input": weights.to_tensor(state["norm_input"]),
                                     "output": weights.to_tensor(state["norm_output"])})


def load_predictor_state(predictor, path: str):
    """Load a native ``model.msgpack``-style predictor state (UNet and VAE
    flax params, normalizers) into ``predictor`` (in place; returns it)."""
    return _load_predictor_tree(predictor, flax_msgpack.load(path), path)


def load_train_state(path: str, predictor, optimizer):
    """Restore a ``train_state.msgpack`` (the port's or the JAX package's)
    into ``predictor`` and ``optimizer``, in place. Returns (predictor,
    optimizer, next epoch, best loss). The weights load strictly; an
    optimizer state of another shape (other ``--ema-decay`` or
    ``--weight-decay`` on/off, other model-shaping flags) raises."""
    state = flax_msgpack.load(path)
    _load_predictor_tree(predictor, state["predictor"], path)
    try:
        optimizer.load_state_tree(state["opt_state"])
    except (ValueError, KeyError) as e:
        raise ValueError(
            f"Optimizer state in {path} does not match the optimizer built from the "
            f"current flags — resume with the same optimizer-shaping flags the run was "
            f"trained with (e.g. --ema-decay on/off must match). Original error: {e}") from e
    return predictor, optimizer, int(state["epoch"]) + 1, float(state["best_loss"])


def peek_train_state_epoch(path: str) -> int:
    """The epoch a train_state.msgpack resumes FROM (decodes the whole file)."""
    return int(flax_msgpack.load(path)["epoch"]) + 1


# file-name orders, the reference's two conventions: split encoder/decoder
# dirs try best_model first (predictor.py:500,511), a single --vae-path dir
# tries vae first (predictor.py:391,438)
_NATIVE_ORDER_SPLIT = ("best_model.msgpack", "vae.msgpack", "model.msgpack")
_NATIVE_ORDER_SINGLE = ("vae.msgpack", "best_model.msgpack", "model.msgpack")


def _load_native_branches(folder: str, order=_NATIVE_ORDER_SPLIT) -> Optional[dict]:
    """The branch dict of a native msgpack VAE checkpoint, if the dir has one."""
    for name in order:
        path = osp.join(folder, name)
        if osp.exists(path):
            return flax_msgpack.load(path)
    return None


def _native_branch(role: str, tree: dict, folder: str) -> StateDict:
    """A native VAE branch's flax params as the state dict of ``role``."""
    return _from_flax(lambda t: weights.export_vae_branch(role, t), tree,
                      f"{role} from {folder}")


def vae_branches(module: nn.Module) -> Tuple[str, ...]:
    """The VAE branches (``encoder_2d``, ...) ``module`` holds as children."""
    return tuple(name for name in BRANCHES if isinstance(getattr(module, name, None), nn.Module))


def vae_params(module: nn.Module, branches=None) -> dict:
    """Flax params of ``module``'s VAE branches (all of them, or
    ``branches``), keyed by branch as the JAX package's VAE run dirs hold
    them: views of the live tensors (snapshot before the next step)."""
    return {name: weights.vae_branch_to_flax(name, getattr(module, name).state_dict())
            for name in branches or vae_branches(module)}


def load_vae_params(module: nn.Module, tree: dict, what: str, branches=None) -> None:
    """Load the flax VAE branch params of a run-dir file into ``module``'s
    branches (all of them, or ``branches``), strictly: a branch missing from
    the tree or one more than expected raises, as does any key or shape."""
    branches = tuple(branches or vae_branches(module))
    if set(tree) != set(branches):
        raise ValueError(f"{what}: holds the branches {sorted(tree)}, expected "
                         f"{sorted(branches)}")
    for name, sd in vae_state_dicts(tree, what).items():
        load_strict(getattr(module, name), sd, f"{name} from {what}")


def vae_state_dicts(tree: dict, what: str) -> Dict[str, StateDict]:
    """Each VAE branch of a flax tree (weights, Adam moments or accumulated
    gradients) as its state dict; a leaf the layout lacks or misses raises."""
    return {name: _native_branch(name, params, what) for name, params in tree.items()}


def _read_log(path: str) -> Optional[dict]:
    if not osp.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def load_dual_vae_from_paths(
    vae_path: Optional[str] = None,
    vae_encoder_path: Optional[str] = None,
    vae_decoder_path: Optional[str] = None,
) -> Tuple[Dict[str, StateDict], Optional[list], str]:
    """The four VAE branches' state dicts from checkpoint dir(s), native
    msgpack or reference ``.pt``: ``({'encoder_2d': sd, ...}, norm_factors,
    flavor)``, each sd keyed relative to its branch.

    A lone split path falls back to ``vae_path`` for the missing side, and
    without ``vae_path`` raises (reference predictor.py:343, 480-481). An
    explicitly passed split path is always honored. Each split dir resolves
    on its own (native msgpack, else ``.pt``), so mixed pairs load."""
    norm_factors = None

    if vae_encoder_path is not None or vae_decoder_path is not None:
        if (vae_encoder_path is None or vae_decoder_path is None) and vae_path is None:
            raise ValueError(
                "VAE path must be provided for latent diffusion, or both "
                "encoder and decoder paths must be specified")
        vae_encoder_path = vae_encoder_path or vae_path
        vae_decoder_path = vae_decoder_path or vae_path
        log = _read_log(osp.join(vae_decoder_path, "vae_log.json"))
        if log is not None:
            norm_factors = log.get("norm_factors")

        def pick(sd, dual_prefix, std_prefix, what):
            sub = ti.strip_prefix(sd, dual_prefix) or ti.strip_prefix(sd, std_prefix)
            if not sub:
                raise ValueError(
                    f"Cannot find {what} weights (looked for '{dual_prefix}' / '{std_prefix}')")
            return sub

        enc_native = _load_native_branches(vae_encoder_path)
        dec_native = _load_native_branches(vae_decoder_path)
        any_native = enc_native is not None or dec_native is not None

        if dec_native is not None:
            if "decoder_3d" not in dec_native or "encoder_3d" not in dec_native:
                raise ValueError(
                    f"Native checkpoint in {vae_decoder_path} lacks the 3D "
                    f"branch (keys: {sorted(dec_native)}); provide the Stage 1 "
                    f"run dir via --vae-decoder-path.")
            d3d = _native_branch("decoder_3d", dec_native["decoder_3d"], vae_decoder_path)
            e3d = _native_branch("encoder_3d", dec_native["encoder_3d"], vae_decoder_path)
        else:
            dec_sd = ti.load_torch_state_dict(ti.find_model_file(
                vae_decoder_path, ("best_model.pt", "vae.pt", "model.pt")))
            d3d = ti.vae_branch_state_dict(pick(dec_sd, "decoder_3d.", "decoder.", "D3D"), decoder=True)
            e3d = ti.vae_branch_state_dict(pick(dec_sd, "encoder_3d.", "encoder.", "E3D"), decoder=False)

        if enc_native is not None:
            e2d = enc_native.get("encoder_2d", enc_native.get("encoder_3d"))
            if e2d is None:
                raise ValueError(
                    f"Native checkpoint in {vae_encoder_path} has neither "
                    f"encoder_2d nor encoder_3d (keys: {sorted(enc_native)})")
            e2d = _native_branch("encoder_2d", e2d, vae_encoder_path)
            d2d = (_native_branch("decoder_2d", enc_native["decoder_2d"], vae_encoder_path)
                   if "decoder_2d" in enc_native else d3d)
        else:
            enc_sd = ti.load_torch_state_dict(ti.find_model_file(
                vae_encoder_path, ("best_model.pt", "vae.pt", "model.pt")))
            e2d = ti.vae_branch_state_dict(pick(enc_sd, "encoder_2d.", "encoder.", "E2D"), decoder=False)
            d2d_sub = ti.strip_prefix(enc_sd, "decoder_2d.")
            d2d = ti.vae_branch_state_dict(d2d_sub, decoder=True) if d2d_sub else d3d

        return ({"encoder_2d": e2d, "encoder_3d": e3d, "decoder_2d": d2d, "decoder_3d": d3d},
                norm_factors, "dual_split_native" if any_native else "dual_split")

    if vae_path is None:
        raise ValueError("VAE path must be provided for latent diffusion, or both "
                         "encoder and decoder paths must be specified")

    log = _read_log(osp.join(vae_path, "vae_log.json"))
    native = _load_native_branches(vae_path, order=_NATIVE_ORDER_SINGLE)
    if native is not None:
        if log is not None:
            norm_factors = log.get("norm_factors")
        if native.get("encoder_3d") is None or native.get("decoder_3d") is None:
            raise ValueError(f"Native checkpoint in {vae_path} lacks the 3D branch")
        e2d = native.get("encoder_2d", native["encoder_3d"])
        d2d = native.get("decoder_2d", native["decoder_3d"])
        trees = {"encoder_2d": e2d, "encoder_3d": native["encoder_3d"],
                 "decoder_2d": d2d, "decoder_3d": native["decoder_3d"]}
        return ({role: _native_branch(role, tree, vae_path) for role, tree in trees.items()},
                norm_factors, "native")

    log_conditional = None
    if log is not None:
        norm_factors = log.get("norm_factors")
        if "conditional" in log:
            log_conditional = bool(log["conditional"])

    sd = ti.load_torch_state_dict(ti.find_model_file(vae_path))
    flavor = ti.detect_vae_checkpoint_type(sd)

    if flavor == "dual_full":
        return ({name: ti.vae_branch_state_dict(ti.strip_prefix(sd, name + "."), name.startswith("decoder"))
                 for name in BRANCHES}, norm_factors, flavor)
    if flavor == "dual_stage1_3d":
        # shared-encoder mode: E3D serves both branches (predictor.py:423-465)
        e3d = ti.vae_branch_state_dict(ti.strip_prefix(sd, "encoder_3d."), decoder=False)
        d3d = ti.vae_branch_state_dict(ti.strip_prefix(sd, "decoder_3d."), decoder=True)
        d2d_sub = ti.strip_prefix(sd, "decoder_2d.")
        d2d = ti.vae_branch_state_dict(d2d_sub, decoder=True) if d2d_sub else d3d
        return ({"encoder_2d": e3d, "encoder_3d": e3d, "decoder_2d": d2d, "decoder_3d": d3d},
                norm_factors, flavor)
    if flavor == "dual_stage2_2d":
        raise ValueError(
            f"Detected Stage 2 (2D only) checkpoint at {vae_path}. It lacks decoder_3d; "
            "provide the Stage 1 path via --vae-decoder-path.")
    if flavor == "standard":
        enc = ti.vae_branch_state_dict(ti.strip_prefix(sd, "encoder."), decoder=False)
        dec = ti.vae_branch_state_dict(ti.strip_prefix(sd, "decoder."), decoder=True)
        # the conditional standard VAE (reference autoencoder.py:130-184): the
        # log's flag and the checkpoint's FiLM weights must agree, as the
        # reference's strict load demands; with no log the keys decide
        has_film = any(k.startswith(("film_in.", "film_out.")) for k in enc) or any(
            k.startswith("film_in.") for k in dec)
        if log_conditional is not None and log_conditional != has_film:
            raise ValueError(
                f"vae_log.json in {vae_path} says conditional="
                f"{log_conditional} but the checkpoint "
                f"{'has' if has_film else 'lacks'} FiLM weights — the "
                f"reference's strict state-dict load would fail on this "
                f"mismatch too")
        if has_film:
            flavor = "standard_conditional"
        return ({"encoder_2d": enc, "encoder_3d": enc, "decoder_2d": dec, "decoder_3d": dec},
                norm_factors, flavor)
    raise ValueError(f"Unrecognized VAE checkpoint flavor in {vae_path}")


def _vae_state_dict(branches: Dict[str, StateDict]) -> StateDict:
    return {f"{name}.{k}": v for name in BRANCHES for k, v in branches[name].items()}


def load_diffusion_torch_checkpoint(predictor, model_path: str):
    """Load a reference diffusion checkpoint (the predictor's state dict):
    ``model.*`` strict; ``vae.*`` strict where present (the reference's
    inference filters them out, keeping the VAE it built); the normalizers.
    Scheduler tables and ``distance_transform`` stay as the predictor was
    built (reference predictor.py:206-218). In place; returns ``predictor``."""
    sd = ti.load_torch_state_dict(model_path)
    load_strict(predictor.model, ti.strip_prefix(sd, "model."), f"model.* from {model_path}")
    vae_sd = ti.strip_prefix(sd, "vae.")
    if vae_sd:
        branches = {name: ti.vae_branch_state_dict(ti.strip_prefix(vae_sd, name + "."),
                                     name.startswith("decoder")) for name in BRANCHES}
        load_strict(predictor.vae, _vae_state_dict(branches), f"vae.* from {model_path}")
    norms = {key: sd.get(f"normalizer.{key}.scale_factors") for key in ("input", "output")}
    return predictor.set_normalizer(norms)


# --------------------------------------------------------------------------
# predictor from a config / run dir
# --------------------------------------------------------------------------

def build_predictor(predictor_kwargs: dict, *, device="cuda"):
    """A predictor from the reference's predictor kwargs (model_name,
    model_kwargs, distance_transform, VAE paths, num_timesteps), with the
    VAE's weights and norm factors where a VAE path is given (its widths from
    the checkpoint's shapes), else the JAX package's seeded VAE init. The
    UNet keeps torch's default init: its weights come from the run dir's
    file. Returns ``(predictor, norm_factors)``."""
    from ..diffusion.predictor import LatentDiffusionPredictor
    from ..models.vae import features_from_decoder_state

    model_name = predictor_kwargs.get("model_name", "UNet")
    if model_name != "UNet":
        raise ValueError(f"Unknown model: {model_name}")
    branches, norm_factors, flavor = None, None, None
    # any VAE path enters the loader, whose either-or rule raises on a lone
    # split path instead of leaving a random VAE
    if (predictor_kwargs.get("vae_path") or predictor_kwargs.get("vae_encoder_path")
            or predictor_kwargs.get("vae_decoder_path")):
        branches, norm_factors, flavor = load_dual_vae_from_paths(
            predictor_kwargs.get("vae_path"), predictor_kwargs.get("vae_encoder_path"),
            predictor_kwargs.get("vae_decoder_path"))

    pred = LatentDiffusionPredictor(
        dict(predictor_kwargs["model_kwargs"]), device=device,
        num_timesteps=predictor_kwargs.get("num_timesteps", 1000),
        distance_transform=predictor_kwargs.get("distance_transform", True),
        vae_features=(features_from_decoder_state(branches["decoder_3d"])
                      if branches else None),
        # dual checkpoints ignore the conditional flag, as the reference does
        vae_conditional=flavor == "standard_conditional")
    pred.requires_grad_(False).eval()
    if branches is not None:
        load_strict(pred.vae, _vae_state_dict(branches), f"VAE ({flavor})")
    else:
        pred.vae.init_parameters_(torch.Generator().manual_seed(0))
    if norm_factors is not None:
        pred.set_normalizer({"output": norm_factors})
    return pred, norm_factors


def diffusion_weight_chain(use_ema: bool = False, folder: Optional[str] = None) -> list:
    """File names a diffusion run dir's weights are looked for under, in order
    (reference inference.py:48-55, native msgpack first). ``use_ema`` puts
    ``ema_model.msgpack`` first and warns when ``folder`` has none."""
    names = ["best_model.msgpack", "model.msgpack", "best_model.pt", "model.pt"]
    if use_ema:
        if folder is not None and not osp.exists(osp.join(folder, "ema_model.msgpack")):
            print(f"WARNING: --use-ema requested but {folder} has no "
                  f"ema_model.msgpack (run trained without --ema-decay?); "
                  f"falling back to {names[0]}-chain RAW weights.")
        names = ["ema_model.msgpack"] + names
    return names


def predictor_from_directory(folder: str, *, device="cuda",
                             vae_path_overrides: Optional[dict] = None,
                             model_kwargs_overrides: Optional[dict] = None,
                             use_ema: bool = False):
    """A predictor from a run dir's ``log.json`` and weights (native msgpack
    first, reference ``.pt`` accepted), on ``device`` (default 'cuda'; raises
    without CUDA unless device='cpu'). ``vae_path_overrides`` remaps
    vae_path / vae_encoder_path / vae_decoder_path; ``model_kwargs_overrides``
    patches the logged UNet kwargs. Returns ``(predictor, params)``, params
    being the log's ``params``."""
    with open(osp.join(folder, "log.json")) as f:
        param_dict = json.load(f)["params"]
    predictor_type = param_dict["training"]["predictor_type"]
    if predictor_type != "latent-diffusion":
        raise ValueError(f"Unknown or unsupported predictor type: {predictor_type}")
    predictor_kwargs = dict(param_dict["training"]["predictor"])
    if vae_path_overrides:
        predictor_kwargs.update(vae_path_overrides)
    if model_kwargs_overrides:
        predictor_kwargs["model_kwargs"] = {
            **predictor_kwargs.get("model_kwargs", {}), **model_kwargs_overrides}
    pred, _ = build_predictor(predictor_kwargs, device=device)

    for name in diffusion_weight_chain(use_ema=use_ema, folder=folder):
        path = osp.join(folder, name)
        if osp.exists(path):
            if name.endswith(".msgpack"):
                return load_predictor_state(pred, path), param_dict
            return load_diffusion_torch_checkpoint(pred, path), param_dict
    raise FileNotFoundError(f"No model weights found in {folder}")

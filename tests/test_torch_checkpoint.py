"""The port's checkpoint loading against the JAX package's, on the CPU.

Run dirs and VAE dirs are written by the JAX package (``save_predictor``,
``utils/torch_export.py``, flax msgpack) from a tiny JAX predictor, in every
format the JAX loader takes: native msgpack, reference ``.pt``, split
encoder / decoder dirs of mixed formats, the standard VAE and the
FiLM-conditional standard VAE, legacy ``layers.N`` names and a whole pickled
module. For each, the port must load exactly the JAX package's parameters
(after the layout transform): a whole run dir through
``predictor_from_directory``, which must also give the JAX DDIM-2 output
within 1e-4 of max|JAX| (a VAE dir alone for the last two formats). Where
the JAX loader raises, the port raises the same error. The port's flax-msgpack decoder is held to
``flax.serialization.msgpack_restore`` bit for bit.
"""
import dataclasses
import json

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from diffusion_model_project_tpu.diffusion.predictor import (
    LatentDiffusionPredictor as JPredictor)
from diffusion_model_project_tpu.utils import checkpoint as jckpt
from diffusion_model_project_tpu.utils import torch_export as te
from diffusion_model_project_tpu.utils import torch_import as ti

from diffusion_model_project_tpu_torch.models.vae import DualBranchVAE
from diffusion_model_project_tpu_torch.utils import checkpoint, flax_msgpack, weights

from test_torch_models import randomize_zero_inits
from test_torch_predictor import LATENT, NORM_OUTPUT, S, HW, UNET_KW, VAE_FEATURES
from test_torch_train_step import one_torch_thread  # noqa: F401

T = 20


# --------------------------------------------------------------- msgpack


def _restore_both(tree):
    data = flax.serialization.msgpack_serialize(tree)
    return flax.serialization.msgpack_restore(data), flax_msgpack.restore(data)


def _assert_same_tree(expected, got, path="root"):
    if isinstance(expected, dict):
        assert isinstance(got, dict) and set(got) == set(expected), path
        for k in expected:
            _assert_same_tree(expected[k], got[k], f"{path}.{k}")
    elif isinstance(expected, list):
        assert isinstance(got, list) and len(got) == len(expected), path
        for i, (e, g) in enumerate(zip(expected, got)):
            _assert_same_tree(e, g, f"{path}[{i}]")
    elif isinstance(expected, np.ndarray) and expected.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == expected.shape, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                      expected.view(np.uint16), err_msg=path)
    elif isinstance(expected, (np.ndarray, np.generic)):
        assert type(got) is type(expected), (path, type(got), type(expected))
        assert got.dtype == expected.dtype and np.shape(got) == np.shape(expected), path
        np.testing.assert_array_equal(got, expected, err_msg=path)
    else:
        assert type(got) is type(expected) and got == expected, (path, got, expected)


def test_msgpack_decoder_equals_flax_restore():
    rng = np.random.default_rng(0)
    bf16 = jax.numpy.asarray(rng.standard_normal((3, 5)), jax.numpy.bfloat16)
    tree = {
        "f32": rng.standard_normal((2, 3, 4)).astype(np.float32),
        "f64": rng.standard_normal(7),
        "bf16": np.asarray(bf16),
        "scalar0d": np.float32(2.5) * np.ones((), np.float32),
        "ints": {name: rng.integers(-100 if name[0] == "i" else 0, 100, (4,)).astype(name)
                 for name in ("int8", "int16", "int32", "int64", "uint8", "uint16",
                              "uint32", "uint64")},
        "bool": np.array([True, False]),
        "np_scalars": {"f": np.float32(1.25), "i": np.int64(-7), "u": np.uint8(200)},
        "py": {"small": 5, "neg": -3, "neg_big": -(2 ** 40), "big": 2 ** 63 + 1,
               "mid": 300, "f": 0.1, "s": "text", "t": True, "f_": False, "none": None,
               "long_str": "x" * 300},
        "list": [1, np.zeros((0, 3), np.float32), "a"],
        "empty": {},
        "nested": {"a": {"b": {"c": np.arange(10, dtype=np.int32)}}},
    }
    expected, got = _restore_both(tree)
    _assert_same_tree(expected, got)


def test_msgpack_decoder_joins_chunked_leaves(monkeypatch):
    # flax splits a leaf larger than MAX_CHUNK_SIZE bytes into chunks
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((7, 9)).astype(np.float32),
            "inner": {"b": rng.standard_normal(40).astype(np.float32),
                      "h": np.asarray(jax.numpy.asarray(rng.standard_normal((6, 11)),
                                                        jax.numpy.bfloat16))},
            "small": np.ones(3, np.float32)}
    data = flax.serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    _assert_same_tree(flax.serialization.msgpack_restore(data), flax_msgpack.restore(data))


def test_msgpack_decoder_refuses_other_types():
    data = flax.serialization.msgpack_serialize({"c": complex(1.0, 2.0)})  # ext type 2
    with pytest.raises(ValueError, match="ext type 2"):
        flax_msgpack.restore(data)
    with pytest.raises(ValueError, match="type byte 0xc1"):  # never used by msgpack
        flax_msgpack.restore(b"\xc1")
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.restore(flax.serialization.msgpack_serialize({"a": np.ones(4)})[:-3])


# --------------------------------------------------------------- run dirs


def _jax_predictor(vae_conditional: bool, seed: int):
    """A JAX predictor whose VAE params come from a seeded port VAE through
    the JAX package's own importer (flax's init of a conditional VAE alone
    costs about 8 s on the CPU); its UNet is flax-initialized."""
    rng = np.random.default_rng(seed)
    vae = DualBranchVAE(latent_channels=LATENT, features=VAE_FEATURES,
                        conditional=vae_conditional)
    vae.init_parameters_(torch.Generator().manual_seed(seed))
    vae_params = ti.import_dual_vae({k: v.numpy() for k, v in vae.state_dict().items()})
    pred = JPredictor.create(dict(UNET_KW), rng=jax.random.key(seed), num_slices=S,
                             num_timesteps=T, latent_channels=LATENT, image_hw=(HW, HW),
                             vae_params=vae_params, vae_conditional=vae_conditional)
    pred = dataclasses.replace(pred, unet_params=randomize_zero_inits(pred.unet_params, rng))
    return pred.set_normalizer({"input": [1.0], "output": NORM_OUTPUT})


@pytest.fixture(scope="module")
def sources():
    return {"plain": _jax_predictor(False, 1), "conditional": _jax_predictor(True, 2)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _write_log(run_dir, vae_paths: dict):
    predictor = {"model_name": "UNet", "model_kwargs": dict(UNET_KW), "distance_transform": True,
                 "num_slices": S, "num_timesteps": T, **vae_paths}
    (run_dir / "log.json").write_text(json.dumps(
        {"params": {"training": {"predictor_type": "latent-diffusion",
                                 "predictor": predictor}}}))


def _vae_log(folder, **extra):
    (folder / "vae_log.json").write_text(json.dumps({"norm_factors": NORM_OUTPUT, **extra}))


def _unet_only_pt(pred, path):
    sd = {k: v for k, v in te.export_predictor(pred).items() if not k.startswith("vae.")}
    te.save_torch_state_dict(sd, str(path))


def _prefixed(prefix, sd):
    return {f"{prefix}{k}": v for k, v in sd.items()}


def _standard_sd(vae_params):
    return {**_prefixed("encoder.", te.export_vae_encoder(vae_params["encoder_3d"])),
            **_prefixed("decoder.", te.export_vae_decoder(vae_params["decoder_3d"]))}


def _legacy(sd, mapping):
    inverse = {new: old for old, new in mapping.items()}
    out = {}
    for k, v in sd.items():
        head, rest = k.split(".", 1)
        out[f"{inverse[head]}.{rest}" if head in inverse else k] = v
    return out


def write_vae_dir(tmp, flavour: str, vp) -> dict:
    """The VAE dir(s) of a run dir of ``flavour``, from the VAE params
    ``vp``; returns the VAE paths its ``log.json`` names."""
    from diffusion_model_project_tpu.utils import torch_import as ti

    vae = tmp / "vae"
    vae.mkdir()
    paths = {"vae_path": str(vae)}
    if flavour == "native":
        jckpt._atomic_write_msgpack(str(vae / "vae.msgpack"), _np(vp))
        _vae_log(vae)
    elif flavour == "pt":
        te.save_torch_state_dict(te.export_dual_vae(vp), str(vae / "vae.pt"))
        _vae_log(vae)
    elif flavour == "dual_stage1_3d":
        te.save_torch_state_dict(te.export_dual_vae(
            {"encoder_3d": vp["encoder_3d"], "decoder_3d": vp["decoder_3d"]}),
            str(vae / "vae.pt"))
        _vae_log(vae)
    elif flavour == "split_mixed":
        enc = tmp / "stage2"
        enc.mkdir()
        jckpt._atomic_write_msgpack(str(enc / "best_model.msgpack"), _np(
            {"encoder_2d": vp["encoder_2d"], "decoder_2d": vp["decoder_2d"]}))
        te.save_torch_state_dict(te.export_dual_vae(
            {"encoder_3d": vp["encoder_3d"], "decoder_3d": vp["decoder_3d"]}),
            str(vae / "best_model.pt"))
        _vae_log(vae)
        paths = {"vae_encoder_path": str(enc), "vae_decoder_path": str(vae)}
    elif flavour in ("standard", "standard_conditional"):
        te.save_torch_state_dict(_standard_sd(vp), str(vae / "vae.pt"))
        _vae_log(vae, conditional=flavour == "standard_conditional")
    elif flavour == "legacy_layers":
        sd = _standard_sd(vp)
        sd = {**_prefixed("encoder.", _legacy(ti.strip_prefix(sd, "encoder."),
                                              ti._ENCODER_LAYER_MAP)),
              **_prefixed("decoder.", _legacy(ti.strip_prefix(sd, "decoder."),
                                              ti._DECODER_LAYER_MAP))}
        assert any(k.startswith("encoder.layers.11.") for k in sd)
        te.save_torch_state_dict(sd, str(vae / "model.pt"))
    elif flavour == "whole_module":
        from diffusion_model_project_tpu_torch.models.vae import DualBranchVAE

        module = DualBranchVAE(latent_channels=LATENT, features=VAE_FEATURES)
        module.load_state_dict(weights.to_tensors(weights.export_dual_vae(vp)), strict=True)
        torch.save(module, str(vae / "vae.pt"))
    else:
        raise AssertionError(flavour)
    return paths


def make_run_dir(tmp, flavour: str, sources) -> str:
    """A diffusion run dir of ``flavour`` (and the VAE dir(s) it names)."""
    run = tmp / "run"
    run.mkdir()
    pred = sources["conditional" if flavour == "standard_conditional" else "plain"]
    paths = write_vae_dir(tmp, flavour, pred.vae_params)
    if flavour == "native":
        jckpt.save_predictor(pred, str(run / "model.msgpack"))
    elif flavour == "pt":
        te.save_torch_state_dict(te.export_predictor(pred), str(run / "best_model.pt"))
    else:
        _unet_only_pt(pred, run / "model.pt")
    _write_log(run, paths)
    return str(run)


FLAVOURS = ["native", "pt", "dual_stage1_3d", "split_mixed", "standard",
            "standard_conditional"]
# one compile for all predictors of one static configuration
_jax_ddim2 = jax.jit(lambda p, img, vel, noise: p.predict_ddim(img, vel, num_steps=2,
                                                               noise=noise))


def _inputs():
    rng = np.random.default_rng(31)
    img = (rng.random((1, S, 1, HW, HW)) > 0.3).astype(np.float32)
    vel = (rng.standard_normal((1, S, 3, HW, HW)) * 1e-2).astype(np.float32)
    vel[:, :, 2] = 0.0
    noise = rng.standard_normal((S, LATENT, HW // 4, HW // 4)).astype(np.float32)
    return img, vel, noise


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_predictor_from_directory_loads_what_jax_loads(tmp_path, sources, flavour):
    run_dir = make_run_dir(tmp_path, flavour, sources)
    jpred, _ = jckpt.predictor_from_directory(run_dir, image_hw=(HW, HW))
    pred, params = checkpoint.predictor_from_directory(run_dir, device="cpu")
    assert params["training"]["predictor_type"] == "latent-diffusion"
    assert pred.vae.conditional == (flavour == "standard_conditional") == jpred.vae.conditional

    expected = te.export_predictor(jpred)
    got = pred.state_dict()
    assert set(got) == set(expected)
    for k, v in expected.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v, np.float32), err_msg=k)

    img, vel, noise = _inputs()
    out_j = np.asarray(_jax_ddim2(jpred, img, vel, noise))
    out = pred.predict_ddim(torch.from_numpy(img), torch.from_numpy(vel), num_steps=2,
                            noise=torch.from_numpy(noise)).numpy()
    scale = np.abs(out_j).max()
    assert scale > 0 and np.abs(out - out_j).max() <= 1e-4 * scale


@pytest.mark.parametrize("flavour", ["legacy_layers", "whole_module"])
def test_vae_dir_loads_what_jax_loads(tmp_path, sources, flavour):
    # the VAE's own formats (legacy layers.N names, a whole pickled module):
    # the branches the port loads are the JAX loader's, exactly
    run_dir = make_run_dir(tmp_path, flavour, sources)
    vae_path = json.load(open(f"{run_dir}/log.json"))["params"]["training"]["predictor"][
        "vae_path"]
    jbranches, jnorm, jflavor = jckpt.load_dual_vae_from_paths(vae_path)
    branches, norm, flavor = checkpoint.load_dual_vae_from_paths(vae_path)
    assert (flavor, norm) == (jflavor, jnorm)
    expected = te.export_dual_vae(jbranches)
    got = {f"{name}.{k}": v for name, sd in branches.items() for k, v in sd.items()}
    assert set(got) == set(expected)
    for k, v in expected.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v, np.float32), err_msg=k)


def test_predictor_from_directory_prefers_ema_and_native(tmp_path, sources, capsys):
    run_dir = make_run_dir(tmp_path, "pt", sources)
    other = dataclasses.replace(sources["plain"], unet_params=jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 1.0, sources["plain"].unet_params))
    # best_model.pt is there; model.msgpack comes first in the chain, and
    # --use-ema takes ema_model.msgpack before both
    jckpt.save_predictor(other, f"{run_dir}/ema_model.msgpack")
    pred, _ = checkpoint.predictor_from_directory(run_dir, device="cpu")
    np.testing.assert_array_equal(pred.model.final_conv.bias.numpy(),
                                  np.asarray(sources["plain"].unet_params["final_conv"]["bias"]))
    pred, _ = checkpoint.predictor_from_directory(run_dir, device="cpu", use_ema=True)
    np.testing.assert_array_equal(pred.model.final_conv.bias.numpy(),
                                  np.asarray(other.unet_params["final_conv"]["bias"]))
    assert checkpoint.diffusion_weight_chain(use_ema=True, folder=str(tmp_path)) == [
        "ema_model.msgpack", "best_model.msgpack", "model.msgpack", "best_model.pt", "model.pt"]
    assert "WARNING: --use-ema" in capsys.readouterr().out


def _both_raise(match, jax_call, port_call, exc=ValueError):
    with pytest.raises(exc, match=match):
        jax_call()
    with pytest.raises(exc, match=match):
        port_call()


def test_lone_split_path_raises_as_jax_does(tmp_path, sources):
    make_run_dir(tmp_path, "split_mixed", sources)
    enc = str(tmp_path / "stage2")
    _both_raise("VAE path must be provided",
                lambda: jckpt.load_dual_vae_from_paths(vae_encoder_path=enc),
                lambda: checkpoint.load_dual_vae_from_paths(vae_encoder_path=enc))
    _both_raise("VAE path must be provided",
                lambda: jckpt.load_dual_vae_from_paths(),
                lambda: checkpoint.load_dual_vae_from_paths())
    # with vae_path the missing side falls back to it
    _, _, flavor = checkpoint.load_dual_vae_from_paths(vae_path=str(tmp_path / "vae"),
                                                       vae_encoder_path=enc)
    assert flavor == "dual_split_native"


def test_stage2_only_checkpoint_raises_as_jax_does(tmp_path, sources):
    vp = sources["plain"].vae_params
    te.save_torch_state_dict(te.export_dual_vae(
        {"encoder_2d": vp["encoder_2d"], "decoder_2d": vp["decoder_2d"]}),
        str(tmp_path / "vae.pt"))
    _both_raise("Detected Stage 2",
                lambda: jckpt.load_dual_vae_from_paths(str(tmp_path)),
                lambda: checkpoint.load_dual_vae_from_paths(str(tmp_path)))


def test_native_dirs_without_a_3d_branch_raise_as_jax_does(tmp_path, sources):
    vp = sources["plain"].vae_params
    jckpt._atomic_write_msgpack(str(tmp_path / "vae.msgpack"), _np({"encoder_2d": vp["encoder_2d"]}))
    _both_raise("lacks the 3D branch",
                lambda: jckpt.load_dual_vae_from_paths(str(tmp_path)),
                lambda: checkpoint.load_dual_vae_from_paths(str(tmp_path)))
    _both_raise("lacks the 3D",
                lambda: jckpt.load_dual_vae_from_paths(vae_encoder_path=str(tmp_path),
                                                       vae_decoder_path=str(tmp_path)),
                lambda: checkpoint.load_dual_vae_from_paths(vae_encoder_path=str(tmp_path),
                                                            vae_decoder_path=str(tmp_path)))


@pytest.mark.parametrize("log_says", [True, False])
def test_log_and_film_disagreement_raises_as_jax_does(tmp_path, sources, log_says):
    # a plain checkpoint logged as conditional, or a FiLM one logged as plain
    pred = sources["plain" if log_says else "conditional"]
    te.save_torch_state_dict(_standard_sd(pred.vae_params), str(tmp_path / "vae.pt"))
    _vae_log(tmp_path, conditional=log_says)
    _both_raise(f"says conditional={log_says}",
                lambda: jckpt.load_dual_vae_from_paths(str(tmp_path)),
                lambda: checkpoint.load_dual_vae_from_paths(str(tmp_path)))


def test_strict_structure_mismatch_raises_as_jax_does(tmp_path, sources):
    # a run dir whose VAE is plain, with weights saved from a predictor whose
    # VAE is conditional: the extra film_* leaves must not load silently
    run_dir = make_run_dir(tmp_path, "native", sources)
    jckpt.save_predictor(sources["conditional"], f"{run_dir}/model.msgpack")
    _both_raise("vae_params from .*does not match the model",
                lambda: jckpt.predictor_from_directory(run_dir, image_hw=(HW, HW)),
                lambda: checkpoint.predictor_from_directory(run_dir, device="cpu"))


def test_port_refuses_unread_leaves_and_wrong_shapes(tmp_path, sources):
    run_dir = make_run_dir(tmp_path, "native", sources)
    pred = checkpoint.build_predictor(json.load(open(f"{run_dir}/log.json"))["params"]
                                      ["training"]["predictor"], device="cpu")[0]
    state = jax.tree_util.tree_map(np.asarray, jckpt.predictor_state(sources["plain"]))
    state["unet_params"]["final_conv"]["extra"] = np.ones(3, np.float32)
    jckpt._atomic_write_msgpack(str(tmp_path / "extra.msgpack"), state)
    with pytest.raises(ValueError, match=r"unexpected key\(s\): \['final_conv.extra'\]"):
        checkpoint.load_predictor_state(pred, str(tmp_path / "extra.msgpack"))
    del state["unet_params"]["final_conv"]["extra"]
    del state["unet_params"]["final_conv"]["bias"]
    jckpt._atomic_write_msgpack(str(tmp_path / "missing.msgpack"), state)
    with pytest.raises(ValueError, match=r"Missing key\(s\): \['final_conv.bias'\]"):
        checkpoint.load_predictor_state(pred, str(tmp_path / "missing.msgpack"))
    sd = {k: v for k, v in te.export_predictor(sources["plain"]).items()}
    sd["model.final_conv.bias"] = np.zeros(LATENT + 1, np.float32)
    te.save_torch_state_dict(sd, str(tmp_path / "shape.pt"))
    with pytest.raises(ValueError, match="shapes do not match"):
        checkpoint.load_diffusion_torch_checkpoint(pred, str(tmp_path / "shape.pt"))


def test_missing_weights_raise_as_jax_does(tmp_path, sources):
    run_dir = make_run_dir(tmp_path, "native", sources)
    import os

    os.remove(f"{run_dir}/model.msgpack")
    _both_raise("No model weights found",
                lambda: jckpt.predictor_from_directory(run_dir, image_hw=(HW, HW)),
                lambda: checkpoint.predictor_from_directory(run_dir, device="cpu"),
                exc=FileNotFoundError)

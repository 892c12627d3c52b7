"""The port's sampler export (``utils/export.py``: ``torch.export`` with K1
and K2 as registered ops) and run-dir converters (``utils/torch_export.py``,
``scripts/export_torch.py``) on the CPU.

A CPU-exported DDIM and DPM program of the tiny predictor (3 x 32^2, 4
steps, one attention level) is held against the port's eager call (1e-6
relative) and against the JAX package's ``load_sampler(export_sampler(...))``
of the same weights (1e-4 of max|JAX|); its graph holds one K1 op a
GroupNorm call and one K2 op an attention call. A port-written run dir
converts to ``.pt`` files equal to the JAX converter's, which the port's
loaders read back bit for bit.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_project_tpu.utils import export as jexport
from diffusion_model_project_tpu.utils import torch_export as jtorch_export

from diffusion_model_project_tpu_torch.models.layers import GroupNorm, MultiheadSelfAttention
from diffusion_model_project_tpu_torch.models.vae import DualBranchVAE
from diffusion_model_project_tpu_torch.scripts import export_sampler as export_cli
from diffusion_model_project_tpu_torch.scripts import export_torch as export_torch_cli
from diffusion_model_project_tpu_torch.utils import export
from diffusion_model_project_tpu_torch.utils.checkpoint import (predictor_from_directory,
                                                                save_predictor, save_tree,
                                                                vae_params)
from diffusion_model_project_tpu_torch.utils.torch_import import load_torch_state_dict

from test_torch_serving import write_run_dir
from test_torch_train_step import (L, NORM_OUTPUT, T, UNET_KW, VAE_FEATURES,  # noqa: F401
                                   jax_twin, one_torch_thread, port_predictor)

S, H, W = 3, 32, 32
STEPS = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pred():
    return port_predictor(seed=5)


@pytest.fixture(scope="module")
def exported(pred):
    """Each sampler exported once at batch 2 and loaded back: ``{sampler:
    (archive bytes, loaded callable)}``; the predictor's weights and
    ``requires_grad`` flags as they were before the exports."""
    before = {k: v.clone() for k, v in pred.state_dict().items()}
    grads = [p.requires_grad for p in pred.parameters()]
    out = {}
    for sampler in ("ddim", "dpm"):
        blob = export.export_sampler(pred, batch=2, num_steps=STEPS, sampler=sampler,
                                     image_hw=(H, W), num_slices=S)
        out[sampler] = (blob, export.load_sampler(blob))
    out["unchanged"] = (all(torch.equal(v, before[k]) for k, v in pred.state_dict().items())
                        and grads == [p.requires_grad for p in pred.parameters()])
    return out


def _inputs(seed, b=1):
    r = np.random.default_rng(seed)
    img = (r.random((b, S, 1, H, W)) > 0.3).astype(np.float32)
    img[:, :, :, 0, 0] = 0.0
    v2d = (r.standard_normal((b, S, 3, H, W)) * 1e-2).astype(np.float32)
    noise = r.standard_normal((b * S, L, H // 4, W // 4)).astype(np.float32)
    return img, v2d, noise


def _eager(pred, sampler, img, v2d, noise):
    args = (torch.from_numpy(img), torch.from_numpy(v2d))
    if sampler == "dpm":
        return pred.predict_dpm(*args, num_steps=STEPS, noise=torch.from_numpy(noise))
    return pred.predict_ddim(*args, num_steps=STEPS, noise=torch.from_numpy(noise))


def _count(module, cls):
    return sum(isinstance(m, cls) for m in module.modules())


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_exported_program_matches_eager_and_jax(pred, exported, sampler):
    blob, f = exported[sampler]
    assert isinstance(blob, bytes) and len(blob) > 1000
    ep = f.program
    ops = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    # DPM-4 evaluates the UNet 4 times here, as DDIM-4 does
    evals = STEPS
    assert ops.count("dm_port.groupnorm_act.default") == (
        _count(pred.model, GroupNorm) * evals + _count(pred.vae.encoder_2d, GroupNorm)
        + _count(pred.vae.decoder_3d, GroupNorm))
    assert ops.count("dm_port.fused_attention.default") == \
        _count(pred.model, MultiheadSelfAttention) * evals > 0
    assert export.input_shapes(ep) == {"img": (2, S, 1, H, W), "velocity_2d": (2, S, 3, H, W),
                                       "noise": (2 * S, L, H // 4, W // 4)}

    img, v2d, noise = _inputs(1, b=2)
    got = f(torch.from_numpy(img), torch.from_numpy(v2d), torch.from_numpy(noise)).numpy()
    want = _eager(pred, sampler, img, v2d, noise).numpy()
    assert got.shape == (2, S, 3, H, W)
    scale = float(np.abs(want).max())
    assert scale > 0 and float(np.abs(got - want).max()) <= 1e-6 * scale

    jblob = jexport.export_sampler(jax_twin(pred), batch=2, num_steps=STEPS, sampler=sampler,
                                   image_hw=(H, W), num_slices=S, platforms=("cpu",),
                                   bake_weights=False)
    jgot = np.asarray(jexport.load_sampler(jblob)(jnp.asarray(img), jnp.asarray(v2d),
                                                  jnp.asarray(noise)))
    jscale = float(np.abs(jgot).max())
    assert float(np.abs(got - jgot).max()) <= 1e-4 * jscale


def test_export_refusals_and_wrong_shapes(pred, exported):
    with pytest.raises(ValueError, match="bake_weights=True is not supported"):
        export.export_sampler(pred, batch=1, num_steps=1, image_hw=(H, W), num_slices=S,
                              bake_weights=True)
    with pytest.raises(ValueError, match="runs on the device it is traced on"):
        export.export_sampler(pred, batch=1, num_steps=1, image_hw=(H, W), num_slices=S,
                              platforms=("cuda",))
    with pytest.raises(ValueError, match="eta must be 0"):
        export.export_sampler(pred, batch=1, num_steps=1, eta=0.5, image_hw=(H, W),
                              num_slices=S)
    with pytest.raises(ValueError, match="unknown sampler"):
        export.export_sampler(pred, batch=1, num_steps=1, sampler="ddpm", image_hw=(H, W),
                              num_slices=S)
    # the exports leave the predictor as it was
    assert exported["unchanged"]
    f = exported["ddim"][1]  # batch 2
    with pytest.raises(ValueError, match="noise: shape"):
        f(torch.zeros((2, S, 1, H, W)), torch.zeros((2, S, 3, H, W)),
          torch.zeros((2 * S, H // 4, W // 4, L)))  # channels-last
    with pytest.raises(ValueError, match="img: shape"):
        f(torch.zeros((1, S, 1, H, W)), torch.zeros((1, S, 3, H, W)),
          torch.zeros((S, L, H // 4, W // 4)))


def test_save_sampler_is_atomic(tmp_path, monkeypatch):
    path = tmp_path / "sampler.pt2"
    path.write_bytes(b"GOOD_ARTIFACT")

    def boom(*a, **k):
        raise RuntimeError("trace OOM")

    monkeypatch.setattr(export, "export_sampler", boom)
    with pytest.raises(RuntimeError, match="trace OOM"):
        export.save_sampler(str(path), None)
    assert path.read_bytes() == b"GOOD_ARTIFACT"
    assert list(tmp_path.glob("*.tmp")) == []

    monkeypatch.setattr(export, "export_sampler", lambda *a, **k: b"NEW_ARTIFACT")
    export.save_sampler(str(path), None)
    assert path.read_bytes() == b"NEW_ARTIFACT"
    assert list(tmp_path.glob("*.tmp")) == []


def test_export_cli_writes_an_archive_a_fresh_process_loads(pred, tmp_path):
    """The export CLI on a run dir; a new process that imports only
    ``utils/export.py`` (which registers the ops) loads and runs the archive
    and matches the run dir's predictor."""
    run = write_run_dir(tmp_path, pred)
    out = tmp_path / "sampler.pt2"
    with pytest.raises(ValueError, match="bake_weights=True"):
        export_cli.main(["--model-dir", str(run), "--out", str(out), "--device", "cpu",
                         "--bake-weights", "true"])
    export_cli.main(["--model-dir", str(run), "--out", str(out), "--batch", "1", "--steps", "1",
                     "--size", str(H), "--slices", str(S), "--device", "cpu"])
    img, v2d, noise = _inputs(2)
    np.savez(tmp_path / "in.npz", img=img, v2d=v2d, noise=noise)
    code = (
        "import sys, numpy as np, torch\n"
        "from diffusion_model_project_tpu_torch.utils.export import load_sampler_file\n"
        f"z = np.load({str(tmp_path / 'in.npz')!r})\n"
        f"f = load_sampler_file({str(out)!r})\n"
        "y = f(*(torch.from_numpy(z[k]) for k in ('img', 'v2d', 'noise')))\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, y.numpy())\n"
        "assert 'diffusion_model_project_tpu_torch.models.unet' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env=dict(os.environ, OMP_NUM_THREADS="1"), timeout=300)
    assert res.returncode == 0, res.stderr
    loaded, _ = predictor_from_directory(str(run), device="cpu")
    want = loaded.predict_ddim(torch.from_numpy(img), torch.from_numpy(v2d), num_steps=1,
                               noise=torch.from_numpy(noise)).numpy()
    got = np.load(tmp_path / "out.npy")
    assert float(np.abs(got - want).max()) <= 1e-6 * float(np.abs(want).max())


# ------------------------------------------------------------ export_torch


def _native_run_dir(root, pred):
    """A diffusion run dir in the native format (``best_model.msgpack``,
    ``model.msgpack``) written by the port's own saver."""
    run, vae = root / "native", root / "vae"
    run.mkdir()
    vae.mkdir()
    save_predictor(pred, str(run / "best_model.msgpack"))
    save_predictor(pred, str(run / "model.msgpack"))
    torch.save(pred.vae.state_dict(), vae / "vae.pt")
    (vae / "vae_log.json").write_text(json.dumps({"norm_factors": NORM_OUTPUT}))
    predictor = {"model_name": "UNet", "model_kwargs": dict(UNET_KW), "distance_transform": True,
                 "num_slices": S, "num_timesteps": T, "vae_path": str(vae)}
    (run / "log.json").write_text(json.dumps({"params": {"training": {
        "predictor_type": "latent-diffusion", "predictor": predictor}}}))
    return run


def test_export_torch_diffusion_dir_loads_back_bit_for_bit(pred, tmp_path):
    run = _native_run_dir(tmp_path, pred)
    out = tmp_path / "pt"
    assert export_torch_cli.main([str(run), "--out-dir", str(out)]) == 0
    assert sorted(os.listdir(out)) == ["best_model.pt", "model.pt"]
    jout = tmp_path / "jax_pt"
    jout.mkdir()
    jtorch_export.export_diffusion_dir(str(run), str(jout))
    want = pred.state_dict()
    for name in ("best_model.pt", "model.pt"):
        sd = load_torch_state_dict(str(out / name))
        jsd = load_torch_state_dict(str(jout / name))
        assert set(sd) == set(jsd) == set(want)
        for k in sd:
            assert torch.equal(sd[k], jsd[k]), k
            assert torch.equal(sd[k], want[k].float()), k
    # the .pt dir alone loads into the port through its reference-.pt path
    (out / "log.json").write_text((run / "log.json").read_text())
    loaded, _ = predictor_from_directory(str(out), device="cpu")
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_export_torch_vae_dir_loads_back_bit_for_bit(tmp_path):
    vae = DualBranchVAE(latent_channels=L, features=VAE_FEATURES)
    gen = torch.Generator().manual_seed(9)
    vae.init_parameters_(gen)
    run = tmp_path / "vae"
    run.mkdir()
    save_tree(str(run / "vae.msgpack"), vae_params(vae))
    (run / "vae_log.json").write_text(json.dumps({"norm_factors": NORM_OUTPUT}))
    assert export_torch_cli.detect_kind(str(run)) == "vae"
    assert export_torch_cli.main([str(run)]) == 0
    jout = tmp_path / "jax"
    jout.mkdir()
    jtorch_export.export_vae_dir(str(run), str(jout))
    sd = load_torch_state_dict(str(run / "vae.pt"))
    jsd = load_torch_state_dict(str(jout / "vae.pt"))
    assert set(sd) == set(jsd)
    assert all(torch.equal(sd[k], jsd[k]) for k in sd)
    back = DualBranchVAE(latent_channels=L, features=VAE_FEATURES)
    back.load_state_dict(sd, strict=True)
    for k, v in vae.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="No native VAE checkpoints"):
        export_torch_cli.main([str(empty), "--kind", "vae"])
    with pytest.raises(SystemExit):
        export_torch_cli.detect_kind(str(empty))

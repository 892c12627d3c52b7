"""The port's VAE trainers end to end (``train_3d_vae_only`` /
``train_2d_with_cross``), on the CPU at a tiny size: 8 microstructures of
16^2 x 3 written by numpy from a seed, latent 4, widths (32, 32, 32), B=2.

The JAX package's own trainer ``main`` runs once a stage, with its steps
stubbed (eager ``accumulate_clipped`` + ``optax.adam`` on fixed gradients, no
VAE compiled; its VAE init replaced by the port's weights), so its real save
code writes a run dir in its own format. Against those: the port's file set,
``vae_log.json`` keys and ``train_state.msgpack`` / weight-file structure
(paths, shapes, dtypes, leaf kinds); JAX's ``load_stage1_params`` (inside its
stage-2 run) and its diffusion-side split loader read the port's dirs
exactly; the port resumes the JAX-written stage-1 state exactly. Then the
port alone: a run stopped after epoch 0 and resumed, streamed, equals the
uninterrupted cached run bit for bit (both stages); ``--ckpt-freq``
gating; the KL-explosion exit; the refused ``--cache-data true --augment``.
"""
import itertools
import json
import os
import os.path as osp
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_model_project_tpu.training import accum as jaccum
from diffusion_model_project_tpu.training import train_vae_stage1 as js1
from diffusion_model_project_tpu.training import train_vae_stage2 as js2
from diffusion_model_project_tpu.utils import checkpoint as jckpt
from diffusion_model_project_tpu.utils import torch_import as ti

from diffusion_model_project_tpu_torch.data.statistics import generate_statistics
from diffusion_model_project_tpu_torch.models.vae import DualBranchVAE
from diffusion_model_project_tpu_torch.training import train_vae_stage1 as s1
from diffusion_model_project_tpu_torch.training import train_vae_stage2 as s2
from diffusion_model_project_tpu_torch.utils import flax_msgpack
from diffusion_model_project_tpu_torch.utils.checkpoint import vae_params

from test_torch_train_step import one_torch_thread  # noqa: F401

N, S, HW, L = 8, 3, 16, 4
TINY = ["--latent-channels", str(L), "--batch-size", "2", "--device", "cpu"]
S1_ARGS = TINY + ["--features", "32", "32", "32", "--grad-accum", "3"]
S2_ARGS = TINY + ["--grad-accum", "2", "--lambda-align", "5", "--lambda-cross", "50"]


def write_dataset(root: str, n: int = N, seed: int = 7) -> str:
    rng = np.random.default_rng(seed)
    os.makedirs(osp.join(root, "x"))
    u2d = (rng.standard_normal((n, S, 3, HW, HW)) * 1e-2).astype(np.float32)
    u2d[:, :, 2] = 0.0
    fields = {"domain.pt": (rng.random((n, S, 1, HW, HW)) > 0.3).astype(np.float32),
              "U_2d.pt": u2d,
              "U.pt": (rng.standard_normal((n, S, 3, HW, HW)) * 1e-2).astype(np.float32),
              "p.pt": rng.standard_normal((n, S, 1, HW, HW)).astype(np.float32),
              "dxyz.pt": np.ones((n, 3), np.float32)}
    for name, arr in fields.items():
        torch.save(torch.from_numpy(arr), osp.join(root, "x", name))
    generate_statistics(root)
    return root


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_dataset(str(tmp_path_factory.mktemp("vae_data") / "d"))


@pytest.fixture(scope="module")
def port_runs(data_dir, tmp_path_factory):
    """The port's stage 1 (2 epochs) and stage 2 on it (2 epochs), cached."""
    base = tmp_path_factory.mktemp("port_vae")
    d1, d2 = str(base / "s1"), str(base / "s2")
    s1.main(["--dataset-dir", data_dir, "--save-dir", d1, "--num-epochs", "2", *S1_ARGS])
    s2.main(["--dataset-dir", data_dir, "--save-dir", d2, "--stage1-checkpoint", d1,
             "--num-epochs", "2", *S2_ARGS])
    return d1, d2


def _metrics(keys, bad=False):
    return {**{k: jnp.float32(0.5) for k in keys}, "bad": jnp.asarray(bad)}


def _stub_train(optimizer, accum_steps, bad_calls):
    """A JAX train step on fixed gradients: JAX's accumulate_clipped and
    optax.adam eagerly, the step-on-boundary rule of its train step."""
    calls = itertools.count()

    def train(params, opt_state, g_acc, boundary):
        k = next(calls)
        grads = jax.tree_util.tree_map(lambda p: jnp.cos(p * 7.0 + k) * 1e-2, params)
        bad = k in bad_calls
        g_acc = jaccum.accumulate_clipped(g_acc, grads, not bad, accum_steps)
        if boundary and not bad:
            updates, opt_state = optimizer.update(g_acc, opt_state, params)
            params = optax.apply_updates(params, updates)
            g_acc = jax.tree_util.tree_map(jnp.zeros_like, g_acc)
        return params, opt_state, g_acc, bad

    def apply(params, opt_state, g_acc):
        updates, opt_state = optimizer.update(g_acc, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    return train, apply


@pytest.fixture(scope="module")
def jax_runs(data_dir, port_runs, tmp_path_factory):
    """JAX's trainer mains with stubbed steps: stage 1 (2 epochs of 3
    batches, accum 3; the last batch bad on its boundary, so the buffer
    carries into the saved state), and stage 2 on the PORT's stage-1 dir."""
    base = tmp_path_factory.mktemp("jax_vae")
    d1, d2 = str(base / "s1"), str(base / "s2")
    port_s1 = s1.Stage1VAE(3, L, features=(32, 32, 32))
    port_s1.init_parameters_(torch.Generator().manual_seed(3))
    params1 = {b: (ti.import_vae_encoder if b.startswith("encoder") else ti.import_vae_decoder)(
        {k: v.detach().numpy().copy() for k, v in getattr(port_s1, b).state_dict().items()})
        for b in ("encoder_3d", "decoder_3d")}
    port_dual = DualBranchVAE(3, L, features=(32, 32, 32))
    port_dual.init_parameters_(torch.Generator().manual_seed(4))
    params2 = ti.import_dual_vae({k: v.detach().numpy().copy()
                                  for k, v in port_dual.state_dict().items()})

    def stage1_steps(vae, loss_name, optimizer, accum_steps=10):
        train, apply = _stub_train(optimizer, accum_steps, bad_calls={5})
        keys = ("recons", "kl", "mu_absmax")

        def train_step(params, opt_state, g_acc, batch, rng, kl_coeff, boundary):
            *state, bad = train(params, opt_state, g_acc, boundary)
            return (*state, _metrics(keys, bad))

        return train_step, apply, lambda *a: _metrics(keys)

    def stage2_steps(vae, loss_name, optimizer, la, lc, accum_steps=5):
        train, apply = _stub_train(optimizer, accum_steps, bad_calls=())
        keys = ("recons_2d", "align", "cross", "kl_2d")

        def train_step(trainable, opt_state, g_acc, frozen, batch, boundary):
            *state, bad = train(trainable, opt_state, g_acc, boundary)
            return (*state, _metrics(keys, bad))

        return train_step, apply, lambda *a: _metrics(keys)

    class StubDual:
        def __init__(self, **kw):
            pass

        def init(self, *a, **kw):
            return {"params": params2}

    common = ["--latent-channels", str(L), "--batch-size", "2", "--data-parallel", "false",
              "--cache-data", "false", "--num-epochs", "2"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(js1.Stage1VAE, "init", lambda self, rng, shape: params1)
        mp.setattr(js1, "make_steps", stage1_steps)
        js1.main(["--dataset-dir", data_dir, "--save-dir", d1, "--features", "32", "32", "32",
                  "--grad-accum", "3", *common])
        mp.setattr(js2, "DualBranchVAE", StubDual)
        mp.setattr(js2, "make_steps", stage2_steps)
        js2.main(["--dataset-dir", data_dir, "--save-dir", d2, "--grad-accum", "2",
                  "--stage1-checkpoint", port_runs[0], *common])
    return d1, d2


def structure(tree, path=()):
    """{path: (leaf kind, dtype, shape)} of a restored msgpack tree."""
    if isinstance(tree, dict):
        out = {path: ("dict",)} if not tree else {}
        for k, v in tree.items():
            out.update(structure(v, path + (k,)))
        return out
    kind = "scalar" if isinstance(tree, np.generic) else type(tree).__name__
    return {path: (kind, str(np.asarray(tree).dtype), np.shape(tree))}


def _log_keys(log: dict) -> dict:
    return {k: (sorted(v) if isinstance(v, dict) else type(v).__name__) for k, v in log.items()}


@pytest.mark.parametrize("stage", [1, 2])
def test_run_dirs_have_the_jax_trainers_layout(stage, port_runs, jax_runs):
    port, jdir = port_runs[stage - 1], jax_runs[stage - 1]
    assert sorted(os.listdir(port)) == sorted(os.listdir(jdir))
    with open(osp.join(port, "vae_log.json")) as f:
        plog = json.load(f)
    with open(osp.join(jdir, "vae_log.json")) as f:
        jlog = json.load(f)
    assert list(plog) == list(jlog) and _log_keys(plog) == _log_keys(jlog)
    assert {k: len(v) for k, v in plog["loss"].items()} == \
        {k: len(v) for k, v in jlog["loss"].items()}
    assert plog["norm_factors"] == jlog["norm_factors"]
    for name in os.listdir(port):
        if name.endswith(".msgpack"):
            assert structure(flax_msgpack.load(osp.join(port, name))) == \
                structure(flax_msgpack.load(osp.join(jdir, name))), name


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.array(tree.detach() if isinstance(tree, torch.Tensor) else tree)


def _assert_trees_equal(a, b):
    assert structure(a) == structure(b)
    for (path, x), (_, y) in zip(sorted(_leaves(a)), sorted(_leaves(b))):
        np.testing.assert_array_equal(x, y, err_msg=str(path))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items() for leaf in _leaves(v, path + (k,))]
    return [(path, np.asarray(tree))]


def test_jax_loaders_read_the_port_run_dirs(port_runs):
    """JAX's load_stage1_params reads the port's stage-1 dir (best_model
    first) and its split loader the port's stage-2 + stage-1 pair, each
    branch equal to the port's file."""
    d1, d2 = port_runs
    best1 = flax_msgpack.load(osp.join(d1, "best_model.msgpack"))
    _assert_trees_equal(_np_tree(js2.load_stage1_params(d1)), best1)
    branches, norm_factors, flavor = jckpt.load_dual_vae_from_paths(
        vae_encoder_path=d2, vae_decoder_path=d1)
    best2 = flax_msgpack.load(osp.join(d2, "best_model.msgpack"))
    _assert_trees_equal(_np_tree({k: branches[k] for k in ("encoder_2d", "decoder_2d")}),
                        {k: best2[k] for k in ("encoder_2d", "decoder_2d")})
    _assert_trees_equal(_np_tree({k: branches[k] for k in ("encoder_3d", "decoder_3d")}),
                        {k: best1[k] for k in ("encoder_3d", "decoder_3d")})
    with open(osp.join(d1, "vae_log.json")) as f:
        assert norm_factors == json.load(f)["norm_factors"]
    # the port's stage 2 froze what stage 1 wrote: its files carry it unchanged
    _assert_trees_equal({k: best2[k] for k in ("encoder_3d", "decoder_3d")},
                        {k: best1[k] for k in ("encoder_3d", "decoder_3d")})


def test_port_resumes_a_jax_stage1_state(data_dir, jax_runs, tmp_path):
    """The JAX-written train_state (Adam count, moments and a carried,
    nonzero accumulated gradient) loads into the port exactly, and the port
    trains on from it: a third epoch appended to JAX's two."""
    state = flax_msgpack.load(osp.join(jax_runs[0], "train_state.msgpack"))
    assert int(state["epoch"]) == 1 and int(state["opt_state"]["0"]["count"]) == 1
    assert any(np.abs(leaf).max() > 0 for _, leaf in _leaves(state["g_acc"]))
    vae = s1.Stage1VAE(3, L, features=(32, 32, 32))
    opt = s1.AccumAdam(vae, 1e-4)
    opt.load(state["opt_state"], state["g_acc"], "JAX's train_state")
    assert opt.count == 1
    _assert_trees_equal(_np_tree(opt.state_tree()), state["opt_state"])
    _assert_trees_equal(_np_tree(opt.g_acc_tree()), state["g_acc"])

    save = str(tmp_path / "resumed")
    shutil.copytree(jax_runs[0], save)
    vae, log = s1.main(["--dataset-dir", data_dir, "--save-dir", save, "--num-epochs", "2",
                        "--resume", *S1_ARGS])  # nothing left to train: the loaded state
    _assert_trees_equal(_np_tree(vae_params(vae)), state["params"])
    _, log = s1.main(["--dataset-dir", data_dir, "--save-dir", save, "--num-epochs", "3",
                      "--resume", *S1_ARGS])
    with open(osp.join(jax_runs[0], "vae_log.json")) as f:
        jlog = json.load(f)
    for key, values in log["loss"].items():
        assert values[:2] == jlog["loss"][key] and len(values) == 3
        assert all(np.isfinite(values))
    assert int(flax_msgpack.load(osp.join(save, "train_state.msgpack"))["epoch"]) == 2


@pytest.mark.parametrize("stage", [1, 2])
def test_streamed_resumed_run_equals_the_cached_uninterrupted_run(stage, data_dir, port_runs,
                                                                  tmp_path):
    """Epoch 0 streamed (--cache-data false), then --resume to 2 epochs:
    vae_log.json's losses and every weight file equal the cached,
    uninterrupted run bit for bit."""
    main, ref = (s1.main, port_runs[0]) if stage == 1 else (s2.main, port_runs[1])
    extra = S1_ARGS if stage == 1 else [*S2_ARGS, "--stage1-checkpoint", port_runs[0]]
    save = str(tmp_path / "run")
    argv = ["--dataset-dir", data_dir, "--save-dir", save, "--cache-data", "false", *extra]
    main([*argv, "--num-epochs", "1"])
    main([*argv, "--num-epochs", "2", "--resume"])
    with open(osp.join(save, "vae_log.json")) as f:
        got = json.load(f)
    with open(osp.join(ref, "vae_log.json")) as f:
        want = json.load(f)
    assert got["loss"] == want["loss"]
    for name in sorted(os.listdir(ref)):
        if name.endswith(".msgpack"):
            _assert_trees_equal(flax_msgpack.load(osp.join(save, name)),
                                flax_msgpack.load(osp.join(ref, name)))


def test_ckpt_freq_gates_the_writes(data_dir, tmp_path, monkeypatch):
    """--ckpt-freq 2 over 3 epochs: the set writes at epochs 0 and 2 (the
    final one), the log holds all three epochs."""
    written = []
    real = s1.save_tree
    monkeypatch.setattr(s1, "save_tree",
                        lambda path, tree, writer=None: (written.append(osp.basename(path)),
                                                         real(path, tree, writer))[1])
    save = str(tmp_path / "freq")
    _, log = s1.main(["--dataset-dir", data_dir, "--save-dir", save, "--num-epochs", "3",
                      "--ckpt-freq", "2", *S1_ARGS])
    assert written.count("train_state.msgpack") == 2 and written.count("vae.msgpack") == 2
    assert len(log["loss"]["recons_train"]) == 3
    with open(osp.join(save, "vae_log.json")) as f:
        assert len(json.load(f)["loss"]["recons_train"]) == 3
    assert int(flax_msgpack.load(osp.join(save, "train_state.msgpack"))["epoch"]) == 2


def test_kl_explosion_exits_1_and_cache_with_augment_is_refused(data_dir, port_runs, tmp_path,
                                                                monkeypatch):
    real = s1.scan_train_metrics
    monkeypatch.setattr(s1, "scan_train_metrics", lambda m: real(m, kl_abort=0.0))
    save = str(tmp_path / "kl")
    with pytest.raises(SystemExit) as e:
        s1.main(["--dataset-dir", data_dir, "--save-dir", save, "--num-epochs", "2", *S1_ARGS])
    assert e.value.code == 1 and os.listdir(save) == []
    for main, extra in ((s1.main, S1_ARGS),
                        (s2.main, [*S2_ARGS, "--stage1-checkpoint", port_runs[0]])):
        with pytest.raises(ValueError, match="incompatible with --augment"):
            main(["--dataset-dir", data_dir, "--save-dir", str(tmp_path / "aug"),
                  "--cache-data", "true", "--augment", *extra])

"""The port's training driver and CLI (``training/train_diffusion.py``,
``train.py``, ``utils/config.py``) on the CPU, against the JAX package:

- the parser, ``process_args``, ``run_descr`` and ``make_log_folder`` equal
  JAX's on several argv (the clock frozen); ``--device`` defaults to cuda;
- every flag whose feature is not ported is refused, naming its ROADMAP.md
  item (``--profile-dir`` and ``--debug-nans`` are accepted since item 7);
- ``train`` mode for 2 epochs on a tiny dataset writes the file set and the
  ``log.json`` schema (and ``params``) of the JAX trainer (run with its
  epoch loop stubbed out: its driver writes the files), and JAX's
  ``predictor_from_directory`` / ``load_train_state`` read the port's run
  dir; the port resumes a JAX-written run dir;
- a run stopped after epoch 1 and resumed equals the uninterrupted run bit
  for bit (weights, optimizer state, losses);
- a preemption stop leaves the state on disk and prints the --resume hint;
- CV skips a complete fold and resumes one whose test loss is missing.
"""
import datetime as dt
import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from diffusion_model_project_tpu.training import train_diffusion as jtrain
from diffusion_model_project_tpu.utils import checkpoint as jckpt
from diffusion_model_project_tpu.utils import config as jconfig

from diffusion_model_project_tpu_torch import train as cli
from diffusion_model_project_tpu_torch.data import get_loader
from diffusion_model_project_tpu_torch.training import train_diffusion
from diffusion_model_project_tpu_torch.training.helper import get_model
from diffusion_model_project_tpu_torch.utils import checkpoint, config
from diffusion_model_project_tpu_torch.utils.preempt import GracefulShutdown

from test_torch_data import write_dataset
from test_torch_train_step import HW, one_torch_thread, port_predictor  # noqa: F401

FILES = ["best_model.msgpack", "log.json", "model.msgpack", "train_state.msgpack"]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A 12-sample dataset of 3 slices of 16^2 (split 8 / 1 / 3) and a VAE dir
    (the tiny predictor's VAE as vae.pt with norm_factors)."""
    root = tmp_path_factory.mktemp("train")
    data = write_dataset(root / "data", n=12, with_y=False, seed=3, hw=HW)
    pred = port_predictor(seed=2)
    (root / "vae").mkdir()
    torch.save(pred.vae.state_dict(), root / "vae" / "vae.pt")
    (root / "vae" / "vae_log.json").write_text(json.dumps({"norm_factors": [0.02, 0.015, 0.01]}))
    base = ["--root-dir", str(data), "--in-channels", "9", "--out-channels", "4",
            "--features", "8", "16", "--attention", "2..2", "--num-slices", "3",
            "--num-timesteps", "20", "--batch-size", "2", "--vae-path", str(root / "vae"),
            "--device", "cpu", "--shuffle", "true", "--augment", "true",
            "--lambda-div", "0.1", "--lambda-velocity", "0.1", "--physics-loss-freq", "2",
            "--weight-decay", "1e-3", "--ema-decay", "0.9", "--learning-rate", "1e-3"]
    return root, base


def _run_dir(save_dir):
    runs = sorted(os.listdir(save_dir))
    assert len(runs) == 1, runs
    return os.path.join(save_dir, runs[0])


def _log(run):
    with open(os.path.join(run, "log.json")) as f:
        return json.load(f)


def _schema(obj):
    if isinstance(obj, dict):
        return {k: _schema(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return ["list", len(obj), sorted({type(v).__name__ for v in obj})]
    return type(obj).__name__


# ------------------------------------------------------------------ config


class _Frozen(dt.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2024, 5, 17, 12, 0, 0)


ARGVS = [
    [],
    ["--name", "x", "--scheduler-flag", "true", "--dropout", "0.1", "--tensorboard"],
    ["--ema-decay", "0.99", "--search-algo", "random", "--learning-rate", "3e-4",
     "--weight-decay", "1e-5", "--features", "32", "64", "--cost-function", "mae_loss",
     "--top-bottom", "false", "true", "--range-batch-size", "4", "8", "--mode", "CV"],
]


@pytest.mark.parametrize("extra", ARGVS)
def test_config_matches_jax(extra, tmp_path, monkeypatch):
    argv = ["--root-dir", "d", "--in-channels", "17", "--out-channels", "8", "--device", "cpu",
            "--save-dir", str(tmp_path), *extra]
    args, jargs = config.parser.parse_args(argv), jconfig.parser.parse_args(argv)
    assert vars(args) == vars(jargs)
    params = config.process_args(args)
    assert params == jconfig.process_args(jargs)
    for with_epochs in (True, False):
        assert config.run_descr(params, with_epochs) == jconfig.run_descr(params, with_epochs)
    monkeypatch.setattr(config, "datetime", _Frozen)
    monkeypatch.setattr(jconfig, "datetime", _Frozen)
    folder = config.make_log_folder(params)
    assert folder == jconfig.make_log_folder(params) and os.path.isdir(folder)
    assert os.path.basename(folder).startswith("20240517_")


def test_device_defaults_to_cuda():
    argv = ["--root-dir", "d", "--in-channels", "17", "--out-channels", "8"]
    assert config.parser.parse_args(argv).device == "cuda"
    assert jconfig.parser.parse_args(argv).device is None
    assert [a.dest for a in config.parser._actions] == [a.dest for a in jconfig.parser._actions]


# flag -> (argv, the ROADMAP.md item that ports it); None: ported since, so
# accepted (item 7's flags, tests/test_torch_profiling.py runs them; items
# 6a and 6b, tests/test_torch_optimize.py and test_torch_cached_latents.py)
REFUSED = {
    "--mode optimize": (["--mode", "optimize"], None),
    "--cache-latents": (["--cache-latents", "true"], None),
    "--model-parallel": (["--model-parallel", "2"], "item 8"),
    "--fsdp": (["--fsdp", "true"], "item 8"),
    "--coordinator": (["--coordinator", "localhost:1234"], "item 8"),
    "--num-processes": (["--num-processes", "2"], "item 8"),
    "--profile-dir": (["--profile-dir", "trace"], None),
    "--debug-nans": (["--debug-nans", "true"], None),
}


@pytest.mark.parametrize("flag", list(REFUSED))
def test_unported_flags_are_refused(env, flag, tmp_path):
    _, base = env
    extra, item = REFUSED[flag]
    argv = base + ["--save-dir", str(tmp_path), *extra]
    if item is None:
        config.refuse_unported(config.parser.parse_args(argv))
        assert os.listdir(tmp_path) == []
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 1 {item} "):
        cli.main(argv)
    with pytest.raises(NotImplementedError, match=flag.split()[0]):
        train_diffusion.train(config.parser.parse_args(argv), [], [])
    assert os.listdir(tmp_path) == []


# ------------------------------------------------------------------ train


@pytest.fixture(scope="module")
def port_run(env):
    """``train`` mode, 2 epochs, uninterrupted."""
    root, base = env
    cli.main(base + ["--save-dir", str(root / "port"), "--num-epochs", "2"])
    return _run_dir(root / "port")


@pytest.fixture(scope="module")
def jax_run(env):
    """The JAX trainer, 2 epochs, its epoch loop stubbed out (the driver
    still builds the predictor and optimizer and writes every file) and an
    empty test split (no eval compile)."""
    root, base = env
    args = jconfig.parser.parse_args(base + ["--save-dir", str(root / "jax"),
                                             "--num-epochs", "2", "--data-parallel", "false"])
    loaders = get_loader(str(root / "data"), batch_size=2, use_3d=True)[0]

    def stub(loaders, predictor, opt_state, optimizer, **kw):
        return predictor, opt_state, 1.25, 1.5, {"div_mean": 0.5, "loss_divergence": 0.25}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "run_epoch", stub)
        jtrain.train(args, loaders[0], loaders[1], [], image_hw=(HW, HW))
    return _run_dir(root / "jax")


def test_train_writes_the_jax_run_dir(port_run, jax_run):
    assert sorted(os.listdir(port_run)) == sorted(os.listdir(jax_run)) \
        == sorted(FILES + ["ema_model.msgpack"])
    log, jlog = _log(port_run), _log(jax_run)
    assert _schema(log) == _schema(jlog)
    assert log["params"] == {**jlog["params"], "save_dir": log["params"]["save_dir"]}
    assert log["epoch"] == [0, 1] and np.isfinite(log["train_loss"] + log["val_loss"]).all()
    assert np.isfinite(log["test_loss"])
    assert log["learning_rate_history"] == [1e-3, 1e-3]
    assert log["physics_metrics"]["loss_divergence"][0] > 0
    assert log["physics_metrics"]["div_mean"][0] > 0
    assert log["physics_metrics"]["loss_smoothness"] == [0.0, 0.0]


def test_jax_reads_the_ports_run_dir(port_run):
    jpred, params = jckpt.predictor_from_directory(port_run, image_hw=(HW, HW))
    ema, _ = jckpt.predictor_from_directory(port_run, image_hw=(HW, HW), use_ema=True)
    jopt = jtrain.make_optimizer(1e-3, 1e-3, ema_decay=0.9)
    restored, state, start, best = jckpt.load_train_state(
        os.path.join(port_run, "train_state.msgpack"), jpred, jopt.init(jpred.unet_params))
    assert start == 2 and best == min(_log(port_run)["val_loss"])
    assert int(state.count) == 8  # 2 epochs x 4 train batches
    port = checkpoint.load_predictor_state(port_predictor(), os.path.join(port_run,
                                                                           "model.msgpack"))
    by_get_model = get_model("latent-diffusion", params["training"]["predictor"],
                             os.path.join(port_run, "model.msgpack"), device="cpu")
    for (k, a), b in zip(by_get_model.state_dict().items(), port.state_dict().values()):
        assert torch.equal(a, b), k
    from diffusion_model_project_tpu_torch.utils import weights

    got = weights.export_unet(jax.tree_util.tree_map(np.asarray, restored.unet_params))
    for k, v in port.model.state_dict().items():
        np.testing.assert_array_equal(got[k], v.numpy())
    ema_sd = weights.export_unet(jax.tree_util.tree_map(np.asarray, ema.unet_params))
    assert any(not np.array_equal(ema_sd[k], v.numpy())
               for k, v in port.model.state_dict().items())


def test_the_port_resumes_a_jax_run_dir(env, jax_run, capsys):
    _, base = env
    cli.main(base + ["--save-dir", "unused", "--num-epochs", "3", "--resume", jax_run])
    assert f"Resumed from {jax_run}" in capsys.readouterr().out
    log = _log(jax_run)
    assert log["epoch"] == [0, 1, 2] and log["train_loss"][:2] == [1.25, 1.25]
    assert log["train_loss"][2] != 1.25 and np.isfinite(log["test_loss"])
    assert checkpoint.peek_train_state_epoch(os.path.join(jax_run, "train_state.msgpack")) == 3


def test_resume_equals_the_uninterrupted_run_bit_for_bit(env, port_run):
    root, base = env
    save = root / "resumed"
    cli.main(base + ["--save-dir", str(save), "--num-epochs", "1"])
    first = _run_dir(save)
    cli.main(base + ["--save-dir", str(save), "--num-epochs", "2", "--resume", first])
    for name in ("model.msgpack", "ema_model.msgpack", "train_state.msgpack",
                 "best_model.msgpack"):
        with open(os.path.join(first, name), "rb") as a, open(os.path.join(port_run, name),
                                                               "rb") as b:
            assert a.read() == b.read(), name
    log, ref = _log(first), _log(port_run)
    for key in ("epoch", "train_loss", "val_loss", "learning_rate_history", "physics_metrics",
                "test_loss"):
        assert log[key] == ref[key], key
    assert log["params"] == {**ref["params"], "save_dir": str(save)}


class _StopAt:
    """A should_stop that turns true at its n-th poll."""

    def __init__(self, n):
        self.n, self.calls = n, 0

    def __call__(self):
        self.calls += 1
        return self.calls >= self.n


def test_preemption_leaves_the_state_on_disk(env, capsys):
    root, base = env
    args = config.parser.parse_args(base + ["--save-dir", str(root / "stop"),
                                            "--num-epochs", "3"])
    train_loader, val_loader, test_loader = get_loader(
        str(root / "data"), batch_size=2, use_3d=True, shuffle=True, augment=True)[0]
    polls = len(train_loader) + len(val_loader) + 1  # each batch, and after the epoch
    stop = _StopAt(polls + 2)  # inside epoch 1's training
    train_diffusion.train(args, train_loader, val_loader, test_loader, should_stop=stop)
    run = _run_dir(root / "stop")
    out = capsys.readouterr().out
    assert "Epoch 1 abandoned" in out and f"Resume with:\n  --resume {run}" in out
    assert checkpoint.peek_train_state_epoch(os.path.join(run, "train_state.msgpack")) == 1
    assert _log(run)["epoch"] == [0] and "test_loss" not in _log(run)
    assert not [f for f in os.listdir(run) if ".tmp." in f]

    # a stop after an epoch that --ckpt-freq gated still writes that epoch
    args = config.parser.parse_args(base + ["--save-dir", str(root / "gated"),
                                            "--num-epochs", "4", "--ckpt-freq", "3"])
    train_diffusion.train(args, train_loader, val_loader, test_loader,
                          should_stop=_StopAt(2 * polls))
    run = _run_dir(root / "gated")
    assert checkpoint.peek_train_state_epoch(os.path.join(run, "train_state.msgpack")) == 2
    assert _log(run)["epoch"] == [0, 1]


def test_graceful_shutdown_turns_a_signal_into_a_stop_request():
    with GracefulShutdown() as shutdown:
        assert not shutdown()
        os.kill(os.getpid(), signal.SIGTERM)
        assert shutdown() and shutdown.requested
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


def test_cv_skips_a_complete_fold_and_resumes_an_unfinished_one(env, capsys):
    root, base = env
    save = root / "cv"
    argv = base + ["--save-dir", str(save), "--mode", "CV", "--k-folds", "2",
                   "--num-epochs", "1"]
    cli.main(argv)
    runs = sorted(os.listdir(save))
    assert [r.split("_")[1] for r in runs] == ["kfold-1.2", "kfold-2.2"]
    logs = {r: _log(save / r) for r in runs}
    assert all("test_loss" in v for v in logs.values())
    capsys.readouterr()

    cli.main(argv)
    out = capsys.readouterr().out
    assert out.count("already complete") == 2 and sorted(os.listdir(save)) == runs
    assert {r: _log(save / r) for r in runs} == logs

    # a fold killed after its last epoch but before its test loss resumes
    unfinished = save / runs[1]
    log = dict(logs[runs[1]])
    test_loss = log.pop("test_loss")
    (unfinished / "log.json").write_text(json.dumps(log))
    cli.main(argv)
    out = capsys.readouterr().out
    assert out.count("already complete") == 1 and f"resuming from {unfinished}" in out
    assert _log(unfinished)["test_loss"] == test_loss
    assert _log(unfinished)["epoch"] == [0] and sorted(os.listdir(save)) == runs

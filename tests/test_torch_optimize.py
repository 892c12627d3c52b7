"""``--mode optimize`` on the port (``training/train_diffusion.py::optimize``
and the ``train.py`` CLI), on the CPU:

- the JAX package's ``tests/test_optimize_pruning.py`` cases on the port:
  pruning wired through ``report_fn`` into ``study.json``'s states, a study
  resumed with the same draws and the pruner's medians rebuilt from the
  recorded intermediates, an interrupted trial resumed in place from its run
  dir with its logged epochs replayed, ``find_resumable_run``;
- a real 2-trial study at tiny widths through the CLI: ``study.json``'s
  keys and states, each trial's run dir, a stop after the first trial and
  a resume that runs only the second, with the JAX sampler's draws.
"""
import json
import math
import os

import pytest
import torch

from diffusion_model_project_tpu.training import tpe as jtpe

from diffusion_model_project_tpu_torch import train as cli
from diffusion_model_project_tpu_torch.training import train_diffusion as td
from diffusion_model_project_tpu_torch.utils.config import parser, process_args, run_descr

from test_torch_data import write_dataset
from test_torch_train_step import HW, one_torch_thread, port_predictor  # noqa: F401


def _optimize_args(tmp_path, n_trials):
    return parser.parse_args([
        "--root-dir", "unused", "--save-dir", str(tmp_path),
        "--in-channels", "17", "--out-channels", "8", "--n-trials", str(n_trials),
        "--range-batch-size", "1", "2", "--range-kernel-size", "3", "5",
        "--range-level", "2", "3", "--range-learning-rate", "1e-4", "1e-2",
        "--top-feature-channels", "8", "--mode", "optimize"])


def test_optimize_wires_pruning_and_records_state(tmp_path, monkeypatch):
    curves = {0: [1.0, 0.9, 0.8], 1: [5.0, 5.0, 5.0], 2: [0.5, 0.4, 0.3]}
    calls = {"n": 0}

    def fake_train(args, tr, va, te, report_fn=None, **kw):
        idx = calls["n"]
        calls["n"] += 1
        for e, v in enumerate(curves[idx]):
            report_fn(e, v)
        return curves[idx][-1], curves[idx][-1]

    monkeypatch.setattr(td, "train", fake_train)
    results = td.optimize(_optimize_args(tmp_path, 3), lambda a: [(None, None, None)],
                          n_startup_trials=1)
    states = [r["state"] for r in results]
    assert states == ["COMPLETE", "PRUNED", "COMPLETE"]
    with open(tmp_path / "study.json") as f:
        saved = json.load(f)
    assert [r["state"] for r in saved] == states
    assert math.isnan(saved[1]["value"])


def test_optimize_study_resumes_crash_safe(tmp_path, monkeypatch):
    seen = []

    def fake_train(args, tr, va, te, report_fn=None, **kw):
        seen.append({"lr": args.learning_rate, "resume": getattr(args, "resume", None),
                     "preloaded": dict(report_fn.intermediates)})
        for e, v in enumerate([1.0, 0.9, 0.8]):
            report_fn(e, v)
        return 0.8, 0.8

    monkeypatch.setattr(td, "train", fake_train)
    args = _optimize_args(tmp_path, 2)
    loaders = lambda a: [(None, None, None)]  # noqa: E731
    first = td.optimize(args, loaders, n_startup_trials=1)
    assert len(seen) == 2 and len(first) == 2

    def bad_train(args, tr, va, te, report_fn=None, **kw):
        seen.append({"lr": args.learning_rate})
        report_fn(0, 50.0)  # far above the recorded epoch-0 median of 1.0
        return 50.0, 50.0

    monkeypatch.setattr(td, "train", bad_train)
    args.n_trials = 3
    second = td.optimize(args, loaders, n_startup_trials=1)
    assert len(seen) == 3
    assert [r["state"] for r in second] == ["COMPLETE", "COMPLETE", "PRUNED"]
    for old, new in zip(first, second):
        assert old["params"] == new["params"]

    # an interrupted trial 2: its record dropped, a run dir of its config left
    with open(tmp_path / "study.json") as f:
        saved = json.load(f)
    p = saved[2]["params"]
    del saved[2]
    with open(tmp_path / "study.json", "w") as f:
        json.dump(saved, f)
    args.batch_size, args.kernel_size = p["batch_size"], p["kernel_size"]
    args.features = [8 * 2 ** v for v in range(p["levels"])]
    args.learning_rate = p["learning_rate"]
    run = tmp_path / f"20260818_x_latent-diffusion_{run_descr(process_args(args), False)}-ep-3"
    os.makedirs(run)
    (run / "train_state.msgpack").write_bytes(b"")
    with open(run / "log.json", "w") as f:
        json.dump({"epoch": [0, 1], "val_loss": [3.0, 2.5]}, f)
    monkeypatch.setattr(td, "train", fake_train)
    third = td.optimize(args, loaders, n_startup_trials=1)
    assert seen[-1]["resume"] == str(run)
    assert seen[-1]["preloaded"] == {0: 3.0, 1: 2.5}
    assert [r["state"] for r in third] == ["COMPLETE"] * 3


def test_find_resumable_run_requires_consistent_pair(tmp_path):
    a, b, c = (tmp_path / f"2026010{i}_run_{x}" for i, x in ((1, "a"), (2, "b"), (3, "c")))
    for d in (a, b, c):
        os.makedirs(d)
    (a / "train_state.msgpack").write_bytes(b"")
    (a / "log.json").write_text(json.dumps({"epoch": [0, 1]}))
    (b / "train_state.msgpack").write_bytes(b"")
    (c / "log.json").write_text(json.dumps({"epoch": [0]}))
    assert td.find_resumable_run(str(tmp_path / "*run*")) == (str(a), 2)
    (c / "train_state.msgpack").write_bytes(b"")
    (c / "log.json").write_text("{not json")
    assert td.find_resumable_run(str(tmp_path / "*run*")) == (str(a), 2)
    assert td.find_resumable_run(str(tmp_path / "*nomatch*")) == (None, 0)


# ------------------------------------------------------------ a real study


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("optimize")
    data = write_dataset(root / "data", n=12, with_y=False, seed=5, hw=HW)
    pred = port_predictor(seed=4)
    (root / "vae").mkdir()
    torch.save(pred.vae.state_dict(), root / "vae" / "vae.pt")
    (root / "vae" / "vae_log.json").write_text(json.dumps({"norm_factors": [0.02, 0.015, 0.01]}))
    return root, ["--root-dir", str(data), "--in-channels", "9", "--out-channels", "4",
                  "--attention", "2..2", "--num-slices", "3", "--num-timesteps", "20",
                  "--vae-path", str(root / "vae"), "--device", "cpu", "--num-epochs", "1",
                  "--mode", "optimize", "--n-trials", "2", "--range-batch-size", "2", "2",
                  "--range-kernel-size", "3", "3", "--range-level", "2", "2",
                  "--range-learning-rate", "1e-4", "1e-3", "--top-feature-channels", "8"]


class _StopAfter:
    """A should_stop that turns true once ``n`` study.json writes landed."""

    def __init__(self, path, n):
        self.path, self.n = path, n
        self.requested = False

    def __call__(self):
        if os.path.exists(self.path):
            with open(self.path) as f:
                self.requested = len(json.load(f)) >= self.n
        return self.requested

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_a_real_study_records_stops_and_resumes(env, tmp_path, monkeypatch, capsys):
    _, base = env
    argv = base + ["--save-dir", str(tmp_path)]
    study = tmp_path / "study.json"
    monkeypatch.setattr(cli, "GracefulShutdown", lambda: _StopAfter(study, 1))
    cli.main(argv)
    assert "Study preempted after 1 recorded trials" in capsys.readouterr().out
    first = json.loads(study.read_text())
    assert len(first) == 1
    monkeypatch.setattr(cli, "GracefulShutdown", lambda: _StopAfter(study, 99))
    cli.main(argv)
    results = json.loads(study.read_text())
    assert results[0] == first[0]
    assert [r["trial"] for r in results] == [0, 1]
    for r in results:
        assert set(r) == {"trial", "state", "value", "params", "intermediates"}
        assert r["state"] == "COMPLETE" and math.isfinite(r["value"])
        assert set(r["params"]) == {"batch_size", "kernel_size", "levels", "learning_rate"}
        assert r["intermediates"] == {"0": r["value"]}
    # the JAX sampler draws the same parameters from the same history
    args = parser.parse_args(argv)
    sampler = jtpe.TPESampler(jtpe.diffusion_search_space(args), seed=2024)
    history = []
    for r in results:
        drawn = sampler.suggest(r["trial"], history)
        assert drawn["learning_rate"] == r["params"]["learning_rate"]
        history.append((r["params"], r["value"]))
    runs = [d for d in os.listdir(tmp_path) if os.path.isdir(tmp_path / d)]
    assert len(runs) == 2
    for d in runs:
        assert {"log.json", "model.msgpack", "train_state.msgpack"} <= set(os.listdir(tmp_path / d))

"""The port's grid search (``scripts/gridsearch_diffusion.py``) on the CPU:

- the grid is the root script's (same entries, same run names);
- a real run of a tiny grid entry through ``--grid-index`` (dry-run
  forward, training, ``results.csv``, the reports), skipped on a rerun, and
  an interrupted entry resumed full-state from its run dir;
- ``--algo tpe``: the rows carry the sampler's seed, a crashed search
  resumes by replaying its trials to the same names, and the draws equal
  the JAX sampler's;
- the standard-library report: ``top10.csv`` holds the rows, in the order
  and with the columns, of the root script's pandas report built here from
  the same ``results.csv``; ``summary.txt`` names the same best run.
"""
import csv
import importlib.util
import json
import math
import os
import os.path as osp

import numpy as np
import pytest
import torch

from diffusion_model_project_tpu.training.tpe import Dim as JDim
from diffusion_model_project_tpu.training.tpe import TPESampler as JTPESampler

from diffusion_model_project_tpu_torch.data import get_loader
from diffusion_model_project_tpu_torch.scripts import gridsearch_diffusion as gs

from test_torch_data import write_dataset
from test_torch_train_step import HW, one_torch_thread, port_predictor  # noqa: F401

REPO = osp.abspath(osp.join(osp.dirname(__file__), ".."))
TINY = {"features": [8, 16], "learning_rate": 1e-3, "kernel_size": 3, "attention": "2..2",
        "dropout": 0.0, "time_embedding_dim": 16}


def _root_script():
    spec = importlib.util.spec_from_file_location(
        "root_gridsearch_diffusion", osp.join(REPO, "gridsearch_diffusion.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_grid_and_names_equal_the_root_script():
    root = _root_script()
    assert gs.GRID == root.GRID and gs.FEATURE_STACKS == root.FEATURE_STACKS
    assert [gs.run_name(c) for c in gs.GRID] == [root.run_name(c) for c in root.GRID]
    assert gs._fixed_cfg([8, 16], 3e-4) == root._fixed_cfg([8, 16], 3e-4)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("grid")
    data = write_dataset(root / "data", n=12, with_y=False, seed=6, hw=HW)
    get_loader(root_dir=str(data), batch_size=2, use_3d=True)  # writes statistics.json
    pred = port_predictor(seed=5)
    (root / "vae").mkdir()
    torch.save(pred.vae.state_dict(), root / "vae" / "vae.pt")
    (root / "vae" / "vae_log.json").write_text(json.dumps({"norm_factors": [0.02, 0.015, 0.01]}))
    return ["--root-dir", str(data), "--in-channels", "9", "--out-channels", "4",
            "--batch-size", "2", "--epochs", "1", "--num-slices", "3", "--num-timesteps", "20",
            "--vae-path", str(root / "vae"), "--device", "cpu"]


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_grid_index_runs_one_entry_skips_it_and_resumes_it(env, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(gs, "GRID", [dict(TINY, learning_rate=5e-4), TINY])
    dry_runs = []
    real_dry_run = gs.dry_run_forward_pass

    def dry_run(predictor, **kw):  # at 32^2: the dry run's size does not matter here
        dry_runs.append(kw)
        return real_dry_run(predictor, **kw, hw=32)

    monkeypatch.setattr(gs, "dry_run_forward_pass", dry_run)
    argv = env + ["--save-dir", str(tmp_path), "--grid-index", "1"]
    gs.main(argv)
    results = tmp_path / "results.csv"
    rows = _rows(results)
    assert [r["run_name"] for r in rows] == [gs.run_name(TINY)]
    assert np.isfinite(float(rows[0]["val_loss"]))
    assert (tmp_path / "top10.csv").exists() and (tmp_path / "summary.txt").exists()
    mtime = os.path.getmtime(results)
    gs.main(argv)
    assert os.path.getmtime(results) == mtime and "[skip]" in capsys.readouterr().out
    # an interrupted entry: its run dir holds train_state.msgpack but results.csv
    # has no row; the rerun resumes it in place and records the same losses
    results.unlink()
    gs.main(argv)
    assert "[resume]" in capsys.readouterr().out
    assert dry_runs == [{"num_slices": 3}] * 2  # before each run, none for the skipped one
    again = _rows(results)
    assert again[0]["val_loss"] == rows[0]["val_loss"]


def _stub(cfg, args, name=None):
    name = name or gs.run_name(cfg)
    return {"run_name": name, "features": json.dumps(cfg["features"]),
            "learning_rate": cfg["learning_rate"], "train_loss": cfg["learning_rate"] * 2,
            "val_loss": cfg["learning_rate"], "wall_time_s": 0.0}


def test_tpe_rows_resume_and_equal_the_jax_draws(tmp_path, monkeypatch):
    monkeypatch.setattr(gs, "FEATURE_STACKS", ([8, 16], [16, 32]))
    calls = {"n": 0}

    def crashing(cfg, args, name=None):
        if calls["n"] == 3:
            raise KeyboardInterrupt("simulated crash")
        calls["n"] += 1
        return _stub(cfg, args, name)

    monkeypatch.setattr(gs, "train_single_config", crashing)
    base = ["--root-dir", "unused", "--save-dir", str(tmp_path), "--algo", "tpe",
            "--tpe-seed", "7", "--n-trials", "6"]
    with pytest.raises(KeyboardInterrupt):
        gs.main(base)
    rows1 = [r["run_name"] for r in _rows(tmp_path / "results.csv")]
    assert len(rows1) == 3 and all(r.startswith("tpe-s7-0") for r in rows1)
    monkeypatch.setattr(gs, "train_single_config", _stub)
    gs.main(base)
    rows = _rows(tmp_path / "results.csv")
    assert [r["run_name"] for r in rows][:3] == rows1
    assert [int(r["run_name"].split("-")[2]) for r in rows] == list(range(6))
    with pytest.raises(SystemExit, match="sequential"):
        gs.main(base + ["--grid-index", "0"])
    # the JAX sampler over the same space draws the same trials
    sampler = JTPESampler([JDim("fidx", 0, 1, integer=True),
                           JDim("learning_rate", 5e-5, 1e-3, log=True)],
                          seed=7, n_startup_trials=2)
    history = []
    for t, r in enumerate(rows):
        p = sampler.suggest(t, history)
        cfg = gs._fixed_cfg(gs.FEATURE_STACKS[int(p["fidx"])], p["learning_rate"])
        assert r["run_name"] == f"tpe-s7-{t:02d}-" + gs.run_name(cfg)
        history.append((p, float(r["val_loss"])))


def test_report_rows_equal_the_pandas_report(tmp_path):
    pd = pytest.importorskip("pandas")
    results = tmp_path / "results.csv"
    rng = np.random.default_rng(0)
    for i in range(13):
        val = float("nan") if i in (4, 9) else float(rng.random())
        gs.append_result(str(results), {
            "run_name": f"f4-32_lr{i}", "features": json.dumps([32, 64, 128, 256][: 2 + i % 3]),
            "learning_rate": [1e-3, 5e-4, 1e-4, 5e-5][i % 4], "train_loss": float(rng.random()),
            "val_loss": val, "wall_time_s": round(float(rng.random()) * 100, 1)})
    gs.create_top10_report(str(results), str(tmp_path))
    ours = (tmp_path / "top10.csv").read_text()
    summary = (tmp_path / "summary.txt").read_text()
    # the root script's pandas report, into another dir
    ref_dir = tmp_path / "pandas"
    ref_dir.mkdir()
    df = pd.read_csv(results).sort_values("val_loss")
    df.head(10).to_csv(ref_dir / "top10.csv", index=False)
    with open(ref_dir / "top10.csv") as f:
        ref = list(csv.reader(f))
    got = list(csv.reader(ours.splitlines()))
    assert got[0] == ref[0] and len(got) == len(ref) == 11
    for a, b in zip(got[1:], ref[1:]):  # pandas re-renders the floats it parsed
        for x, y in zip(a, b):
            try:
                fx, fy = float(x or "nan"), float(y or "nan")
            except ValueError:
                assert x == y
            else:
                assert (math.isnan(fx) and math.isnan(fy)) or math.isclose(fx, fy, rel_tol=1e-13)
    best = df.iloc[0]
    assert f"  run: {best['run_name']}\n" in summary
    assert summary.startswith("Grid search: 13 completed runs\n")
    top = pd.read_csv(tmp_path / "top10.csv")
    assert list(top.columns) == list(df.columns) and len(top) == 10
    assert math.isclose(float(summary.split("val_loss: ")[1]), float(best["val_loss"]))

"""The port's plot CLIs (``scripts/plot_loss.py``, ``plot_physics_metrics.py``,
``plot_vae_loss.py``; host-side matplotlib) on run dirs the port's own
trainers wrote at a tiny size: the diffusion train CLI (1 epoch, with the
physics metrics) and the stage-1 / stage-2 VAE trainers (2 epochs each).
Each plot must parse its log and write a PNG.
"""
import json
import os

import pytest
import torch

from diffusion_model_project_tpu_torch import train as train_cli
from diffusion_model_project_tpu_torch.scripts import plot_loss, plot_physics_metrics, plot_vae_loss
from diffusion_model_project_tpu_torch.training import train_vae_stage1 as s1
from diffusion_model_project_tpu_torch.training import train_vae_stage2 as s2

from test_torch_data import write_dataset
from test_torch_train_step import HW, one_torch_thread, port_predictor  # noqa: F401
from test_torch_vae_train import S1_ARGS, S2_ARGS
from test_torch_vae_train import write_dataset as write_vae_dataset


@pytest.fixture(scope="module")
def diffusion_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("plot_diffusion")
    data = write_dataset(root / "data", n=8, with_y=False, seed=6, hw=HW)
    pred = port_predictor(seed=2)
    (root / "vae").mkdir()
    torch.save(pred.vae.state_dict(), root / "vae" / "vae.pt")
    (root / "vae" / "vae_log.json").write_text(json.dumps({"norm_factors": [0.02, 0.015, 0.01]}))
    train_cli.main(["--root-dir", str(data), "--in-channels", "9", "--out-channels", "4",
                    "--features", "8", "16", "--attention", "2..2", "--num-slices", "3",
                    "--num-timesteps", "20", "--batch-size", "2", "--vae-path",
                    str(root / "vae"), "--device", "cpu", "--num-epochs", "2",
                    "--lambda-div", "0.1", "--physics-loss-freq", "1",
                    "--save-dir", str(root / "runs")])
    (run,) = os.listdir(root / "runs")
    return str(root / "runs" / run)


@pytest.fixture(scope="module")
def vae_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("plot_vae")
    data = write_vae_dataset(str(base / "d"))
    d1, d2 = str(base / "s1"), str(base / "s2")
    s1.main(["--dataset-dir", data, "--save-dir", d1, "--num-epochs", "2", *S1_ARGS])
    s2.main(["--dataset-dir", data, "--save-dir", d2, "--stage1-checkpoint", d1,
             "--num-epochs", "2", *S2_ARGS])
    return d1, d2


def _png(path) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == b"\x89PNG\r\n\x1a\n" and os.path.getsize(path) > 1000


@pytest.mark.parametrize("log_scale", [False, True])
def test_plot_loss(diffusion_run, tmp_path, log_scale):
    out = tmp_path / "loss.png"
    plot_loss.main(["--model-dir", diffusion_run, "--output", str(out)]
                   + (["--log-scale"] if log_scale else []))
    assert _png(out)


def test_plot_loss_default_output_is_in_the_run_dir(diffusion_run):
    plot_loss.main(["--model-dir", diffusion_run])
    assert _png(os.path.join(diffusion_run, "loss.png"))


def test_plot_physics_metrics_compares_runs(diffusion_run, tmp_path):
    with open(os.path.join(diffusion_run, "log.json")) as f:
        metrics = json.load(f)["physics_metrics"]
    assert all(len(metrics[k]) == 2 for k, _ in plot_physics_metrics.PANELS)
    out = tmp_path / "phys.png"
    plot_physics_metrics.main(["--model-dirs", diffusion_run, diffusion_run,
                               "--output", str(out)])
    assert _png(out)


@pytest.mark.parametrize("stage", [0, 1])
def test_plot_vae_loss_both_stages(vae_runs, tmp_path, stage):
    out = tmp_path / f"vae{stage}.png"
    plot_vae_loss.main(["--model-dir", vae_runs[stage], "--output", str(out)])
    assert _png(out)
    with open(os.path.join(vae_runs[stage], "vae_log.json")) as f:
        loss = json.load(f)["loss"]
    assert ("recons_2d_train" in loss) == (stage == 1)

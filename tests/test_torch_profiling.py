"""The port's profiling utilities (``utils/profiling.py``) and the train
CLI's ``--profile-dir`` / ``--debug-nans`` on the CPU.

``profile_trace`` writes a ``torch.profiler`` trace with the ``annotate``
regions in it; ``enable_nan_debugging`` raises ``FloatingPointError`` naming
the module whose forward output, or the gradient reaching it, holds a NaN or
Inf, and anomaly mode stops a backward function that returns a NaN. The
train CLI traces epoch 0 into ``--profile-dir`` and, with ``--debug-nans``,
stops at the first module a NaN in the data reaches.
"""
import json
import os

import numpy as np
import pytest
import torch
from torch import nn

from diffusion_model_project_tpu_torch import train as cli
from diffusion_model_project_tpu_torch.utils import profiling

from test_torch_data import write_dataset
from test_torch_train_step import HW, one_torch_thread, port_predictor  # noqa: F401


@pytest.fixture
def nan_debugging():
    profiling.enable_nan_debugging()
    yield
    profiling.enable_nan_debugging(False)


def _traces(path):
    return [os.path.join(root, f) for root, _, files in os.walk(path) for f in files
            if f.endswith(".pt.trace.json")]


def test_profile_trace_writes_a_trace_with_the_annotations(tmp_path):
    with profiling.profile_trace(str(tmp_path / "trace")):
        with profiling.annotate("dm_step"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    traces = _traces(tmp_path / "trace")
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "dm_step" in names and "aten::mm" in names


def test_nan_in_a_forward_output_raises_naming_the_module(nan_debugging):
    net = nn.Sequential(nn.Linear(4, 4), nn.ReLU(), nn.Linear(4, 2))
    with torch.no_grad():
        net[2].weight[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="forward output of module .*Linear"):
        net(torch.ones(3, 4))
    with torch.no_grad():
        net[2].weight[0, 0] = float("inf")
    with pytest.raises(FloatingPointError, match="NaN or Inf"):
        net(torch.ones(3, 4))
    with torch.no_grad():
        net[2].weight[0, 0] = 0.0
    assert torch.isfinite(net(torch.ones(3, 4))).all()


def test_nan_in_backward_raises(nan_debugging):
    net = nn.Sequential(nn.Linear(4, 4), nn.ReLU())
    with torch.no_grad():
        net[0].bias.fill_(-100.0)  # ReLU outputs exactly 0
    # the gradient of sqrt at 0 is Inf and reaches the ReLU's output
    loss = torch.sqrt(net(torch.ones(3, 4))).sum()
    with pytest.raises(FloatingPointError, match="gradient of the output of module .*ReLU"):
        loss.backward()
    # a backward function that returns a NaN is stopped by anomaly mode
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="returned nan values"):
        (torch.sqrt(x) * 0.0).sum().backward()  # 0 x the Inf of sqrt's gradient


def test_nan_debugging_switches_off():
    profiling.enable_nan_debugging()
    profiling.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
    out = nn.Linear(2, 2)(torch.full((1, 2), float("nan")))
    assert torch.isnan(out).all()


@pytest.fixture(scope="module")
def train_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("observe")
    data = write_dataset(root / "data", n=8, with_y=False, seed=4, hw=HW)
    pred = port_predictor(seed=2)
    (root / "vae").mkdir()
    torch.save(pred.vae.state_dict(), root / "vae" / "vae.pt")
    (root / "vae" / "vae_log.json").write_text(json.dumps({"norm_factors": [0.02, 0.015, 0.01]}))
    base = ["--root-dir", str(data), "--in-channels", "9", "--out-channels", "4",
            "--features", "8", "16", "--attention", "2..2", "--num-slices", "3",
            "--num-timesteps", "20", "--batch-size", "2", "--vae-path", str(root / "vae"),
            "--device", "cpu", "--num-epochs", "1"]
    return root, base


def test_train_cli_profile_dir_traces_epoch_0(train_env):
    root, base = train_env
    cli.main(base + ["--save-dir", str(root / "runs"), "--profile-dir", str(root / "trace")])
    traces = _traces(root / "trace")
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
    assert len(os.listdir(root / "runs")) == 1


def test_train_cli_debug_nans_stops_at_the_first_module(train_env, tmp_path):
    root, base = train_env
    cli.main(base + ["--save-dir", str(tmp_path / "clean"), "--debug-nans", "true"])
    try:
        assert torch.is_anomaly_enabled()
        # the same run on data whose 3D velocity carries a NaN
        data = tmp_path / "data"
        write_dataset(data, n=8, with_y=False, seed=4, hw=HW)
        u = torch.load(data / "x" / "U.pt")
        u[:, 0, 0, 0, 0] = float("nan")
        torch.save(u, data / "x" / "U.pt")
        argv = list(base)
        argv[argv.index("--root-dir") + 1] = str(data)
        with pytest.raises(FloatingPointError, match="NaN or Inf in the forward output of "
                                                     "module diffusion_model_project_tpu_torch"):
            cli.main(argv + ["--save-dir", str(tmp_path / "nan"), "--debug-nans", "true"])
    finally:
        profiling.enable_nan_debugging(False)
    (run,) = os.listdir(tmp_path / "clean")
    with open(tmp_path / "clean" / run / "log.json") as f:
        assert np.isfinite(json.load(f)["train_loss"][0])

"""K3's plain version and wrapper, and the port's conv probe, on the CPU in float32.

The reference is the JAX probe ``scripts/perf_probe_conv.py``, loaded from
its file: its Pallas nine-shift conv (``make_pallas_conv``) in interpret mode
at one tile per image, and its ``conv_xla`` at shapes the kernel tiles many
times with ragged edges. Inputs come from a seeded numpy generator and go to
both sides, in the same NHWC x HWIO layout. The kernel itself is checked on
the card by tests/test_torch_cuda.py.
"""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffusion_model_project_tpu_torch.ops.cuda import conv3x3 as k3
from diffusion_model_project_tpu_torch.scripts import perf_probe_conv as probe

from test_torch_train_step import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
# float32 sums over 9 * Cin taps, in another order on each side
TOL = 1e-5


@pytest.fixture(scope="module")
def jprobe():
    spec = importlib.util.spec_from_file_location("jax_perf_probe_conv",
                                                  REPO / "scripts" / "perf_probe_conv.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(rng, n, h, w, cin, cout):
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wgt = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    return x, wgt


def _assert_close(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() <= TOL * np.abs(ref).max()


def test_plain_matches_pallas_kernel_at_one_tile(jprobe, rng):
    n, h, w, cin, cout = 2, 8, 16, 8, 8
    x, wgt = _inputs(rng, n, h, w, cin, cout)
    with pltpu.force_tpu_interpret_mode():
        run = jprobe.make_pallas_conv(n, h, w, cin, cout, th=h, tw=w, dtype=jnp.float32)
        ref = run(jnp.asarray(x), jnp.asarray(wgt))
    _assert_close(k3.conv3x3_plain(torch.from_numpy(x), torch.from_numpy(wgt)), ref)


@pytest.mark.parametrize("shape", [
    (3, 13, 37, 24, 40),   # many 8x16 tiles, ragged in H, W and Cout
    (1, 5, 4, 3, 7),       # smaller than one tile, odd channel counts
])
def test_plain_and_wrapper_match_conv_xla(jprobe, rng, shape):
    x, wgt = _inputs(rng, *shape)
    ref = jprobe.conv_xla(jnp.asarray(x), jnp.asarray(wgt))
    tx, tw = torch.from_numpy(x), torch.from_numpy(wgt)
    _assert_close(k3.conv3x3_plain(tx, tw), ref)
    before = k3.LAUNCHES
    for tile in k3.TILES:  # a CPU tensor takes the plain version at every tile
        _assert_close(k3.conv3x3(tx, tw, tile), ref)
    assert k3.LAUNCHES == before


def test_plain_rounds_once_to_the_input_dtype(rng):
    x, wgt = _inputs(rng, 2, 6, 9, 16, 24)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(wgt).bfloat16()
    got = k3.conv3x3(xb, wb)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, k3.conv3x3_plain(xb.float(), wb.float()).bfloat16())


def test_wrapper_refuses_grad_and_bad_input():
    x = torch.zeros((1, 4, 4, 8))
    w = torch.zeros((3, 3, 8, 8))
    with pytest.raises(RuntimeError, match="no backward"):
        k3.conv3x3(x, w.requires_grad_())
    with torch.no_grad():
        k3.conv3x3(x, w)  # no grad: accepted
    w = w.detach()
    with pytest.raises(ValueError, match="expected x"):
        k3.conv3x3(x, torch.zeros((3, 3, 4, 8)))
    with pytest.raises(ValueError, match="expected x"):
        k3.conv3x3(x, torch.zeros((8, 8, 3, 3)))
    with pytest.raises(TypeError, match="dtype"):
        k3.conv3x3(x, w.bfloat16())
    with pytest.raises(TypeError, match="dtype"):
        k3.conv3x3(x.double(), w.double())
    with pytest.raises(ValueError, match="tile"):
        k3.conv3x3(x, w, (8, 8))


def test_probe_runs_a_tiny_stage_on_the_cpu():
    results = probe.main(["--device", "cpu", "--shape", "2", "8", "16", "8", "8",
                          "--iters", "1"])
    assert [r["candidate"] for r in results] == ["conv2d_bf16", "k3[8x16]", "k4_int8"]
    flops = 2 * 9 * 2 * 8 * 16 * 8 * 8
    for r in results:
        assert r["shape"] == [2, 8, 16, 8, 8] and r["ms"] > 0
        assert r["tflops"] == pytest.approx(flops / r["ms"] / 1e9)
    # both round a float32 sum of |values| < 8 to bf16 once: half an ulp is < 2^-6
    assert all(0 <= r["max_abs_err"] <= 2.0 ** -6 for r in results[:2])
    # the int8 row against K4's plain version: equal
    assert results[2]["max_abs_err"] == 0 and results[2]["bound_by"] == "bytes"


def test_probe_bound_matches_the_stage_arithmetic():
    # 2 * 9 * 44 * H * W * Cin * Cout = 0.850 TFLOP at every stage: 0.860 ms at 989 TFLOP/s
    for shape in probe.STAGES.values():
        assert probe.flops(*shape) == 2 * 9 * 44 * 256 * 256 * 128 * 128
        b = probe.bound(*shape)
        assert b["bound_by"] == "operations"
        assert b["bound_ms"] == pytest.approx(0.860, abs=5e-4)
    assert probe.bound(*probe.STAGES["A"])["bytes"] == 2 * (44 * 256 * 256 * 256 + 9 * 128 * 128)


def test_probe_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        probe.main(["--shape", "2", "8", "16", "8", "8"])

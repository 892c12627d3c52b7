"""The inputs are made from the seed alone, and every seed gets the same amount of work."""
import numpy as np
import pytest
import torch

from h100_bench import traffic, weights
from h100_bench.entries import loadgen
from h100_bench.tests import tiny


def test_pool_is_deterministic_in_the_seed():
    cfg = tiny.ldm()
    a = traffic.sampler_pool(cfg, 4, tiny.SEED, "cpu")
    b = traffic.sampler_pool(cfg, 4, tiny.SEED, "cpu")
    c = traffic.sampler_pool(cfg, 4, tiny.SEED + 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_fibres_masks_and_velocity():
    cfg = tiny.ldm()
    img, v2d = traffic.sampler_pool(cfg, 6, 5, "cpu")
    solid = 1 - img[:, 0, 0]
    assert set(img.unique().tolist()) <= {0.0, 1.0}
    assert torch.all(solid.flatten(1).sum(1) > 0) and torch.all(img[:, 0, 0].flatten(1).sum(1) > 0)
    assert torch.equal(img[:, 0], img[:, -1])             # extruded along z
    assert torch.all(v2d[:, :, 2] == 0) and torch.all(v2d * (1 - img) == 0)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7])
def test_every_seed_gets_the_same_sizes(seed):
    assert np.allclose(np.sort(traffic.coverages(8, 0.4, 1.0, seed)),
                       np.sort(traffic.coverages(8, 0.4, 1.0, 3)))
    g = traffic.arrival_gaps(500, 7.0, seed)
    assert np.allclose(np.sort(g), np.sort(traffic.arrival_gaps(500, 7.0, 3)))
    assert abs(g.mean() - 1 / 7.0) < 0.01


def test_schedules_calls_and_weights_repeat():
    cfg = tiny.ldm()
    assert np.array_equal(loadgen.schedule(7.0, 30.0, 9), loadgen.schedule(7.0, 30.0, 9))
    assert torch.equal(traffic.call_rows(32, 8, 9, 3, "cpu"), traffic.call_rows(32, 8, 9, 3, "cpu"))
    assert torch.equal(traffic.call_noise(cfg, 2, 9, 3, "cpu"),
                       traffic.call_noise(cfg, 2, 9, 3, "cpu"))
    w1, w2 = weights.make(cfg, 9, "cpu"), weights.make(cfg, 9, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    live = [t for k, t in w1.items() if "final_conv" in k or "proj_out" in k]
    assert live and all(float(t.abs().max()) > 0 for t in live)


def test_frozen_mfr1_is_the_port_s_frame():
    from diffusion_model_project_tpu_torch.utils import serving

    from h100_bench import mfr1

    img, v2d = (t[0].numpy() for t in traffic.sampler_pool(tiny.ldm(), 1, 3, "cpu"))
    assert mfr1.encode_request(img, v2d, 2 ** 40 + 3) == serving.encode_raw_request(
        img, v2d, seed=2 ** 40 + 3)
    vel = np.random.default_rng(0).standard_normal((3, 3, 32, 32)).astype(np.float32)
    assert np.array_equal(mfr1.decode_response(serving.encode_raw_response(vel)), vel)

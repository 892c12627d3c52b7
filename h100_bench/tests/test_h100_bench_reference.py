"""The plain reference agrees with the port at a tiny size on the CPU (float32),
and the benchmark's weights are the port's leaves, name for name."""
import pytest
import torch

from h100_bench import core, port, traffic, weights
from h100_bench.entries import sampler, train_vae_stage1
from h100_bench.reference import sampler as ref
from h100_bench.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_weights_are_the_port_s_leaves():
    cfg = tiny.ldm()
    pred = port.predictor(cfg, weights.make(cfg, 3, CPU), CPU)
    sd = pred.state_dict()
    for name, shape, _ in weights.model_specs(cfg):
        assert tuple(sd[name].shape) == shape
    used = {k for k in sd if k.startswith(("model.", "vae.encoder_2d.", "vae.decoder_3d."))}
    assert used == {n for n, _, _ in weights.model_specs(cfg)}
    vae = port.stage1(tiny.vae(), weights.make(tiny.vae(), 3, CPU), CPU)[0]
    assert set(vae.state_dict()) == {n for n, _, _ in weights.model_specs(tiny.vae())}


@pytest.mark.parametrize("traffic_name", ["ddim50-b16", "dpm10-b8"])
def test_sampler_reference_agrees_with_the_port(traffic_name):
    cfg, wl = tiny.ldm(), tiny.workload(traffic_name)
    cell = sampler.Cell(cfg, wl, tiny.SEED, CPU)
    got = cell.call(5)
    want = sampler.reference_calls(cfg, wl, tiny.SEED, 5, CPU)
    got = sampler.readings(got, want)
    assert got["worst_volume"] < 1e-5 and got["rel_l2_over_bf16"] < 1e-2


def test_edt_and_request_noise():
    img = torch.ones(1, 5, 5)
    img[0, 2, 2] = 0.0
    d = ref.edt(img)[0]
    assert d[2, 2] == 0 and d[0, 0] == pytest.approx(2 ** 1.5) and d[2, 4] == 2
    a = ref.request_noise(7, (3, 8, 4, 4))
    from diffusion_model_project_tpu_torch.utils.serving import request_noise
    assert torch.equal(a, request_noise(7, (3, 8, 4, 4)))


def test_training_reference_follows_the_port():
    cfg, wl = tiny.vae(), tiny.workload("stage1-b2")
    trainer = train_vae_stage1.Trainer(cfg, wl, tiny.SEED, CPU)
    cycles = trainer.checked_cycles()
    w, want = train_vae_stage1.reference_cycles(cfg, wl, tiny.SEED, CPU)
    steps = train_vae_stage1.CHECKED_STEPS
    assert want["steps"] == steps and trainer.opt.count == steps
    assert len(cycles["losses"]) == len(want["losses"]) == steps * cfg["train"]["grad_accum"]
    got = train_vae_stage1.gaps(w, cycles, want)
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-4 and got["update_gap"] < 1e-3
    assert got["left_out"] > 0        # conv biases ahead of GroupNorm: nought to rounding


def test_pool_rows_of_the_checked_cycles_all_differ():
    cfg = core.load_json("configs", "vae-published.json")
    wl = core.load_json("workloads", "stage1-b2.json")
    b = cfg["train"]["batch_size"]
    n = train_vae_stage1.CHECKED_STEPS * cfg["train"]["grad_accum"]
    perm = traffic.pool_order(wl["pool"], tiny.SEED, CPU)
    rows = torch.cat([perm[b * k:b * k + b] for k in range(n)])
    assert len(set(rows.tolist())) == n * b

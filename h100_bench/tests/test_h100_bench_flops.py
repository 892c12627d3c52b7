"""The yardstick's counts: model FLOPs against torch.utils.flop_counter on the
reference at a small size, and K1 / K2's bytes and operations from the shapes."""
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench import flops, weights
from h100_bench.reference import nets
from h100_bench.reference.sampler import nets_prefix
from h100_bench.tests import tiny


def counted(fn) -> int:
    with FlopCounterMode(display=False) as mode:
        fn()
    return mode.get_total_flops()


@pytest.mark.parametrize("attention", ["2..2", "1..2", ""])
def test_unet_flops_match_the_counter(attention):
    cfg = tiny.ldm()
    cfg["unet"]["attention"] = attention
    p = nets_prefix(weights.make(cfg, 1, "cpu"), "model.")
    x = torch.randn(6, cfg["unet"]["in_channels"], 16, 16)
    t = torch.full((6,), 5)
    with torch.no_grad():
        got = counted(lambda: nets.unet(p, cfg["unet"], x, t))
    assert got == flops.unet_eval(cfg["unet"], 6, 16, 16)


def test_vae_flops_match_the_counter():
    cfg = tiny.vae()
    w = weights.make(cfg, 1, "cpu")
    v = cfg["vae"]
    x = torch.randn(2, 3, 3, 16, 16)
    with torch.no_grad():
        n_enc = counted(lambda: nets.encoder(nets_prefix(w, "encoder_3d."), v, x))
        z = torch.randn(2, v["latent_channels"], 3, 4, 4)
        n_dec = counted(lambda: nets.decoder(nets_prefix(w, "decoder_3d."), v, z))
    assert n_enc == flops.encoder(v, 2, 3, 16, 16)
    assert n_dec == flops.decoder(v, 2, 3, 16, 16)


def test_train_step_is_three_forwards_and_the_counter_sees_about_that():
    cfg = tiny.vae()
    cfg["train"]["remat"] = False
    w = {k: t.requires_grad_(True) for k, t in weights.make(cfg, 1, "cpu").items()}
    v = cfg["vae"]
    x = torch.randn(2, 3, 3, 16, 16)

    def step():
        mu, _ = nets.encoder(nets_prefix(w, "encoder_3d."), v, x)
        nets.decoder(nets_prefix(w, "decoder_3d."), v, mu).sum().backward()

    model = flops.encoder(v, 2, 3, 16, 16) + flops.decoder(v, 2, 3, 16, 16)
    ours = flops.train_step({**cfg, "volume": {"slices": 3, "height": 16, "width": 16}}, 2)
    assert ours == 3 * model
    # the counter leaves out conv_in's input gradient, which nothing needs
    assert 0.97 * ours <= counted(step) <= ours


def test_published_counts_are_the_issue_s():
    cfg = __import__("h100_bench.core", fromlist=["x"]).load_json("configs", "ldm-published.json")
    assert flops.unet_eval(cfg["unet"], 1, 64, 64) == pytest.approx(8.7e9, rel=0.02)
    assert flops.encoder(cfg["vae"], 1, 1, 256, 256) == pytest.approx(672e9, rel=0.02)
    assert flops.decoder(cfg["vae"], 1, 1, 256, 256) == pytest.approx(930e9, rel=0.02)
    assert flops.evaluations("dpm", 10, 1000) == 10 and flops.evaluations("ddim", 50, 1000) == 50


def test_k1_and_k2_arithmetic_from_shapes():
    shape = (88, 64, 64, 64)
    assert flops.k1_bytes(shape, 2) == 2 * math.prod(shape) * 2 + 2 * 64 * 4
    assert flops.k1_bound_s(shape, 2) == flops.k1_bytes(shape, 2) / 3.35e12
    n, t, e = 88, 256, 256
    qkv, out = 2 * n * t * e * 3 * e, 2 * n * t * e * e
    scores = pv = 2 * n * t * t * e
    assert flops.k2_flops(n, t, e) == qkv + scores + pv + out
    assert flops.k2_bytes(n, t, e, 2) == 2 * (2 * n * t * e + 3 * e * e + e * e + 3 * e + e)
    assert flops.k2_bound_s(n, t, e, "bfloat16") == max(flops.k2_flops(n, t, e) / 989e12,
                                                         flops.k2_bytes(n, t, e, 2) / 3.35e12)

"""``--cache-latents`` on the port (``training/steps.py`` and
``training/helper.py``'s cached-latent parts, the trainer's cache branch),
on the CPU:

- ``flip_variant_batch`` and ``flip_variant_draws`` equal JAX's exactly;
- ``precompute_latent_cache`` equals JAX's on the same weights (rtol 1e-4;
  JAX's tensors are channels-last, transposed here);
- the cached loss equals the uncached loss under the same noise and t
  within 1e-6 relative, and so do its UNet gradients (1e-5), also for each
  flip variant against the loss of the flipped raw batch (the JAX
  package's ``tests/test_cached_latents.py`` bounds);
- ``run_epoch_cached`` trains and reads the flip cache by the draws;
- the train CLI with ``--cache-latents`` (with and without ``--augment``)
  writes every epoch's log, and refuses physics and velocity losses.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_project_tpu.data.dataset import MicroFlowDataset as JDataset
from diffusion_model_project_tpu.training import helper as jhelper
from diffusion_model_project_tpu.training import steps as jsteps

from diffusion_model_project_tpu_torch import train as cli
from diffusion_model_project_tpu_torch.data.dataset import MicroFlowDataset
from diffusion_model_project_tpu_torch.training import helper, steps

from test_torch_data import write_dataset
from test_torch_train_step import (HW, S, GradCapture, jax_twin, make_batch,  # noqa: F401
                                   native_conv3d, one_torch_thread, port_predictor)

B = 2


@pytest.fixture(scope="module")
def pred():
    return port_predictor(seed=7)


@pytest.fixture(scope="module")
def raw():
    batch = make_batch(11, b=B)
    batch["U"] = batch["U"] * 50  # latents of a few units, as the real targets give
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("fh,fz", [(True, False), (False, True), (True, True)])
def test_flip_variant_batch_equals_jax(raw, fh, fz):
    got = steps.flip_variant_batch(raw, fh, fz)
    ref = jsteps.flip_variant_batch({k: jnp.asarray(v.numpy()) for k, v in raw.items()}, fh, fz)
    for k in ("img", "U_2d", "U"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def _data(n=6, hw=8):
    r = np.random.default_rng(7)
    return {"microstructure": (r.random((n, S, 1, hw, hw)) > 0.3).astype(np.float32),
            "velocity": r.standard_normal((n, S, 3, hw, hw)).astype(np.float32),
            "velocity_input": r.standard_normal((n, S, 3, hw, hw)).astype(np.float32),
            "pressure": r.standard_normal((n, S, 1, hw, hw)).astype(np.float32),
            "dxyz": np.full((n, 3), 1e-6, np.float32)}


def test_flip_variant_draws_equal_jax_and_replay_the_dataset():
    data = _data()
    ds = MicroFlowDataset("unused", augment=True, use_3d=True, data=data)
    jds = JDataset("unused", augment=True, use_3d=True, data=data)
    for epoch in (0, 3):
        v = helper.flip_variant_draws(ds, epoch)
        np.testing.assert_array_equal(v, jhelper.flip_variant_draws(jds, epoch))
        assert set(np.unique(v)) <= {0, 1, 2, 3}
        for i in range(len(ds)):
            got = ds[i]
            ds.augment = False
            exp = steps.flip_variant_batch(
                {"img": torch.from_numpy(ds[i]["microstructure"][None]),
                 "U_2d": torch.from_numpy(ds[i]["velocity_input"][None]),
                 "U": torch.from_numpy(ds[i]["velocity"][None])}, bool(v[i] & 1), bool(v[i] & 2))
            ds.augment = True
            np.testing.assert_array_equal(got["velocity"], exp["U"][0].numpy())


def test_precompute_latent_cache_equals_jax(pred, raw, native_conv3d):
    cache = steps.precompute_latent_cache(pred, raw)
    ld = S // pred.vae_depth_factor
    assert cache["x0"].shape == (B, ld, pred.latent_channels, HW // 4, HW // 4)
    assert cache["m"].shape == (B, ld, 1, HW // 4, HW // 4)
    jpred = jax_twin(pred)
    ref = jax.jit(jsteps.precompute_latent_cache)(
        jpred, {k: jnp.asarray(v.numpy()) for k, v in raw.items()})
    for k in ("x0", "z", "m"):
        r = np.moveaxis(np.asarray(ref[k]), -1, 2)
        np.testing.assert_allclose(cache[k].numpy(), r, rtol=1e-4, atol=1e-4 * np.abs(r).max())


def _draws(b, seed):
    g = torch.Generator().manual_seed(seed)
    noise = torch.randn((b * S, 4, HW // 4, HW // 4), generator=g)
    return noise, torch.randint(0, 20, (b * S,), generator=g)


def _loss_and_grads(pred, fn, batch, noise, t):
    opt = GradCapture(pred.model)
    opt.zero_grad()
    with torch.enable_grad():
        pred.model.requires_grad_(True)
        loss, _ = fn(pred, batch, noise=noise, t=t)
        loss.backward()
        pred.model.requires_grad_(False)
    return loss.item(), [p.grad.clone() for p in opt.params]


@pytest.mark.parametrize("fh,fz", [(False, False), (True, False), (True, True)])
def test_cached_loss_and_grads_equal_the_uncached_ones(pred, raw, fh, fz):
    """The flip variant's cache row against the regular loss of the flipped
    raw batch, under the same noise and t."""
    flipped = steps.flip_variant_batch(raw, fh, fz) if fh or fz else raw
    cache = steps.precompute_latent_cache(pred, flipped)
    noise, t = _draws(B, seed=3)
    ref, g_ref = _loss_and_grads(pred, steps.diffusion_loss_fn, flipped, noise, t)
    got, g_got = _loss_and_grads(pred, steps.cached_latent_loss_fn, cache, noise, t)
    assert abs(got - ref) <= 1e-6 * abs(ref)
    for a, b in zip(g_got, g_ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_cached_loss_draws_noise_then_t_as_forward(pred, raw):
    cache = steps.precompute_latent_cache(pred, raw)
    with torch.no_grad():
        got, _ = steps.cached_latent_loss_fn(pred, cache, torch.Generator().manual_seed(9))
        ref, _ = steps.diffusion_loss_fn(pred, raw, torch.Generator().manual_seed(9))
    assert abs(got.item() - ref.item()) <= 1e-6 * abs(ref.item())


def test_cached_epoch_trains_and_reads_the_flip_cache(pred, raw):
    from diffusion_model_project_tpu_torch.training.train_diffusion import make_optimizer

    variants = [steps.precompute_latent_cache(
        pred, steps.flip_variant_batch(raw, *v) if any(v) else raw) for v in helper.FLIP_VARIANTS]
    flip_cache = {k: torch.cat([c[k] for c in variants]) for k in variants[0]}
    state = {k: v.clone() for k, v in pred.model.state_dict().items()}
    try:
        opt = make_optimizer(pred.model, 1e-3)
        pred.model.requires_grad_(True)
        tr, vl, metrics = helper.run_epoch_cached(
            (flip_cache, variants[0]), pred, opt, generator=torch.Generator().manual_seed(1),
            batch_size=1, variant_idx=np.array([3, 1]), n_train=B)
        assert np.isfinite(tr) and np.isfinite(vl) and metrics == {}
        moved = [n for n, v in pred.model.state_dict().items() if not torch.equal(v, state[n])]
        assert moved
    finally:
        pred.model.requires_grad_(False)
        pred.model.load_state_dict(state)
    # variant 3 of sample 0 is row 3 n + 0
    torch.testing.assert_close(flip_cache["x0"][3 * B], variants[3]["x0"][0])


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("cached")
    data = write_dataset(root / "data", n=12, with_y=False, seed=8, hw=HW)
    p = port_predictor(seed=6)
    (root / "vae").mkdir()
    torch.save(p.vae.state_dict(), root / "vae" / "vae.pt")
    (root / "vae" / "vae_log.json").write_text(json.dumps({"norm_factors": [0.02, 0.015, 0.01]}))
    return ["--root-dir", str(data), "--in-channels", "9", "--out-channels", "4",
            "--features", "8", "16", "--attention", "2..2", "--num-slices", "3",
            "--num-timesteps", "20", "--batch-size", "2", "--vae-path", str(root / "vae"),
            "--device", "cpu", "--shuffle", "true", "--cache-latents", "true"]


@pytest.mark.parametrize("augment", ["false", "true"])
def test_cache_latents_cli(env, tmp_path, augment, capsys):
    cli.main(env + ["--save-dir", str(tmp_path), "--num-epochs", "2", "--ckpt-freq", "2",
                    "--augment", augment])
    out = capsys.readouterr().out
    assert "Latent caches built" in out and ("4 flip variants" in out) == (augment == "true")
    runs = os.listdir(tmp_path)
    assert len(runs) == 1
    run = tmp_path / runs[0]
    log = json.loads((run / "log.json").read_text())
    assert len(log["epoch"]) == 2
    assert np.isfinite(log["train_loss"]).all() and np.isfinite(log["val_loss"]).all()
    assert all(v == [0.0, 0.0] for v in log["physics_metrics"].values())
    assert {"model.msgpack", "best_model.msgpack", "train_state.msgpack"} <= set(os.listdir(run))


@pytest.mark.parametrize("flag", [["--lambda-div", "0.1"], ["--lambda-velocity", "0.1"],
                                  ["--velocity-loss-primary", "true"]])
def test_cache_latents_refuses_physics_and_velocity(env, tmp_path, flag):
    with pytest.raises(ValueError, match="physics/velocity"):
        cli.main(env + ["--save-dir", str(tmp_path), "--num-epochs", "1", *flag])

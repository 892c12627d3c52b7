"""The port's training step (``training/steps.py``), its optimizer
(``training/train_diffusion.py::make_optimizer``) and ``train_trace()``
against the JAX package, on the CPU in float32.

A tiny predictor (latent 4, UNet (8, 16) with attention '2..2', VAE
(32, 32, 32), 3 slices of 16^2, T=20) is built by the port with the JAX
initializers from a seeded generator (``final_conv`` and ``proj_out`` made
nonzero) and carried into a JAX predictor through the JAX package's own
importer, so no flax init runs. Noise and timesteps follow JAX's key split
(noise first, then t) and are passed to the port explicitly. Losses agree
within 1e-4 relative and UNet gradients within 1e-4 of max|JAX grad|; one
Adam step with L2 and EMA agrees with optax within 1e-5 of max|JAX|.
Other test files import the helpers here.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_model_project_tpu.diffusion.predictor import LatentDiffusionPredictor as JP
from diffusion_model_project_tpu.diffusion.scheduler import DiffusionScheduler as JScheduler
from diffusion_model_project_tpu.models import layers as jlayers
from diffusion_model_project_tpu.models.unet import UNet as JUNet
from diffusion_model_project_tpu.models.vae import DualBranchVAE as JVAE
from diffusion_model_project_tpu.ops.normalizer import MaxNormalizer as JNorm
from diffusion_model_project_tpu.training import steps as jsteps
from diffusion_model_project_tpu.training import train_diffusion as jtrain
from diffusion_model_project_tpu.utils import torch_import as ti

from diffusion_model_project_tpu_torch.diffusion.predictor import LatentDiffusionPredictor
from diffusion_model_project_tpu_torch.models import layers
from diffusion_model_project_tpu_torch.models.layers import GroupNorm, train_trace
from diffusion_model_project_tpu_torch.models.unet import UNet
from diffusion_model_project_tpu_torch.training import steps
from diffusion_model_project_tpu_torch.training.train_diffusion import ema_params, make_optimizer
from diffusion_model_project_tpu_torch.utils import weights
from diffusion_model_project_tpu_torch.utils.checkpoint import (predictor_from_directory,
                                                                save_predictor)

L, S, HW, T = 4, 3, 16, 20
UNET_KW = dict(in_channels=2 * L + 1, out_channels=L, features=(8, 16), kernel_size=3,
               padding_mode="zeros", activation="silu", final_activation=None,
               attention="2..2", dropout=0.0, time_embedding_dim=64)
VAE_FEATURES = (32, 32, 32)
NORM_OUTPUT = [2.1e-2, 1.6e-2, 7.9e-3]
COST = "normalized_mse_loss_per_component"


def port_predictor(seed=0, unet_kw=None):
    """The port's tiny predictor, with nonzero final_conv and proj_out."""
    pred = LatentDiffusionPredictor.create(dict(unet_kw or UNET_KW), seed=seed, device="cpu",
                                           num_timesteps=T, latent_channels=L,
                                           vae_features=VAE_FEATURES)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in pred.model.named_parameters():
            if name.startswith("final_conv") or ".proj_out." in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return pred.set_normalizer({"input": [1.0], "output": NORM_OUTPUT})


def _np(sd):
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


def jax_twin(pred) -> JP:
    """The JAX predictor with the port's weights, through the JAX importer."""
    kw = dict(UNET_KW, features=tuple(UNET_KW["features"]))
    return JP(unet=JUNet(**kw), vae=JVAE(latent_channels=L, features=VAE_FEATURES),
              num_slices=S, num_timesteps=T, distance_transform=True,
              unet_params=ti.import_unet(_np(pred.model.state_dict()),
                                         num_levels=len(kw["features"])),
              vae_params=ti.import_dual_vae(_np(pred.vae.state_dict())),
              scheduler=JScheduler.create(T), norm_input=JNorm([1.0]),
              norm_output=JNorm(NORM_OUTPUT))


def make_batch(seed, b=2):
    rng = np.random.default_rng(seed)
    img = (rng.random((b, S, 1, HW, HW)) > 0.3).astype(np.float32)
    v2d = (rng.standard_normal((b, S, 3, HW, HW)) * 1e-2).astype(np.float32)
    v2d[:, :, 2] = 0.0
    v3d = (rng.standard_normal((b, S, 3, HW, HW)) * 1e-2).astype(np.float32)
    return {"img": img, "U_2d": v2d, "U": v3d}


def jax_draws(key, b):
    """JAX forward's draws from ``key`` (noise then t), in the port's layout."""
    r_noise, r_t = jax.random.split(key)
    noise = jax.random.normal(r_noise, (b * S, HW // 4, HW // 4, L), jnp.float32)
    t = jax.random.randint(r_t, (b * S,), 0, T)
    return (torch.from_numpy(np.moveaxis(np.asarray(noise), -1, 1).copy()),
            torch.from_numpy(np.asarray(t).astype(np.int64)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's tiny CPU steps (thousands of small
    ops): with several test workers on the machine, each worker's eight
    OpenMP threads spin against the others' and a training test takes up to
    30 times its CPU time (measured under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def native_conv3d():
    """JAX's VAE with native 3D convs (its depth-shifted 2D decomposition is
    the same conv in another summation order) halves JAX's compile time."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "CONV3D_DECOMPOSE", False)
        yield


def jax_value_and_grad(jpred, **kw):
    """jitted (params, batch, key) -> ((loss, aux), grads) of JAX's
    diffusion_loss_fn, traced under JAX's train_trace() like its train step."""
    def f(params, batch, key):
        with jlayers.train_trace():
            return jax.value_and_grad(
                lambda p: jsteps.diffusion_loss_fn(p, jpred, batch, key, cost_name=COST, **kw),
                has_aux=True)(params)
    return jax.jit(f)


def port_grads(pred) -> dict:
    return {n: p.grad.detach().numpy().copy() for n, p in pred.model.named_parameters()}


def assert_grads_close(got: dict, jax_grads, tol=1e-4):
    expected = weights.export_unet(jax.tree_util.tree_map(np.asarray, jax_grads))
    assert set(got) == set(expected)
    scale = max(np.abs(v).max() for v in expected.values())
    assert scale > 0
    worst = max(np.abs(got[k] - expected[k]).max() for k in expected)
    assert worst <= tol * scale, (worst, scale)
    assert all(np.abs(got[k]).max() > 0 for k in got)  # every parameter is trained


class GradCapture:
    """An optimizer that leaves the parameters alone (the step's gradients
    stay in ``.grad``)."""

    def __init__(self, module):
        self.params = list(module.parameters())

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            p.grad = None

    def step(self):
        pass


@pytest.fixture(scope="module")
def pair():
    pred = port_predictor(seed=3)
    return pred, jax_twin(pred)


@pytest.fixture(scope="module")
def plain_grad(pair, native_conv3d):
    """JAX's plain value_and_grad at B=1 (one compile, three uses)."""
    return jax_value_and_grad(pair[1])


def test_plain_loss_and_grads_match_jax(pair, plain_grad):
    pred, jpred = pair
    batch = make_batch(1, b=1)
    key = jax.random.key(7)
    (loss_j, aux_j), grads_j = plain_grad(jpred.unet_params, batch, key)
    noise, t = jax_draws(key, 1)
    pred.model.requires_grad_(True)
    try:
        with train_trace():
            loss, aux = steps.diffusion_loss_fn(pred, batch, noise=noise, t=t, cost_name=COST)
            loss.backward()
        got = port_grads(pred)
    finally:
        pred.model.requires_grad_(False)
        pred.model.zero_grad(set_to_none=True)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-4)
    assert set(aux) == set(aux_j) == {"noise_loss", "primary_loss", "loss"}
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(aux_j[k]), rtol=1e-4)
        assert not aux[k].requires_grad
    assert_grads_close(got, grads_j)


def test_accum_steps_2_averages_microbatches_as_jax(pair, plain_grad):
    """JAX's accum step splits its key in two, one a microbatch of one
    sample, and averages grads and aux (its lax.scan)."""
    pred, jpred = pair
    batch = make_batch(2, b=2)
    rngs = jax.random.split(jax.random.key(11), 2)
    outs = [plain_grad(jpred.unet_params, {k: v[i:i + 1] for k, v in batch.items()}, rngs[i])
            for i in range(2)]
    grads_j = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, outs[0][1], outs[1][1])
    aux_j = {k: (float(outs[0][0][1][k]) + float(outs[1][0][1][k])) / 2 for k in outs[0][0][1]}
    draws = [jax_draws(r, 1) for r in rngs]
    noise = torch.cat([d[0] for d in draws])
    t = torch.cat([d[1] for d in draws])
    pred.model.requires_grad_(True)
    try:
        step = steps.make_diffusion_train_step(GradCapture(pred.model), cost_name=COST,
                                               accum_steps=2)
        aux = step(pred, batch, noise=noise, t=t)
        got = port_grads(pred)
    finally:
        pred.model.requires_grad_(False)
        pred.model.zero_grad(set_to_none=True)
    for k in aux_j:
        np.testing.assert_allclose(aux[k].item(), aux_j[k], rtol=1e-4)
    assert_grads_close(got, grads_j)
    with pytest.raises(ValueError, match="microbatches"):
        steps.make_diffusion_train_step(GradCapture(pred.model), accum_steps=3)(
            pred, batch, noise=noise, t=t)


def test_train_step_draws_noise_then_t_from_the_generator(pair):
    """Without explicit noise and t the step draws them from the generator,
    each microbatch in turn, as forward() does."""
    pred = pair[0]
    batch = make_batch(3, b=2)
    pred.model.requires_grad_(True)
    try:
        step = steps.make_diffusion_train_step(GradCapture(pred.model), accum_steps=2)
        aux = step(pred, batch, torch.Generator().manual_seed(5))
        gen = torch.Generator().manual_seed(5)
        noise, t = [], []
        for _ in range(2):
            noise.append(torch.randn((S, L, HW // 4, HW // 4), generator=gen))
            t.append(torch.randint(0, T, (S,), generator=gen))
        again = step(pred, batch, noise=torch.cat(noise), t=torch.cat(t))
    finally:
        pred.model.requires_grad_(False)
        pred.model.zero_grad(set_to_none=True)
    assert all(torch.equal(aux[k], again[k]) for k in aux)


@pytest.mark.parametrize("weight_decay,ema_decay", [(0.0, 0.0), (1e-2, 0.9)])
def test_optimizer_steps_match_optax(weight_decay, ema_decay):
    """Two steps (the second at another learning rate, as the per-epoch
    schedule sets it) of the port's Adam + coupled L2 + EMA against the JAX
    package's optax chain on the same gradients."""
    model = UNet(**UNET_KW)
    model.init_parameters_(torch.Generator().manual_seed(0))
    opt = make_optimizer(model, 1e-2, weight_decay, ema_decay)
    params_j = ti.import_unet(_np(model.state_dict()), num_levels=2)
    jopt = jtrain.make_optimizer(1e-2, weight_decay, ema_decay=ema_decay)
    state_j = jopt.init(params_j)

    @jax.jit
    def j_step(grads, state, params):
        updates, state = jopt.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    rng = np.random.default_rng(4)
    for lr in (1e-2, 3e-3):
        grads = {n: rng.standard_normal(p.shape).astype(np.float32)
                 for n, p in model.named_parameters()}
        opt.learning_rate = lr
        state_j.hyperparams["learning_rate"] = lr
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
        params_j, state_j = j_step(ti.import_unet(grads, num_levels=2), state_j, params_j)

    def check(got_sd, tree):
        expected = weights.export_unet(jax.tree_util.tree_map(np.asarray, tree))
        scale = max(np.abs(v).max() for v in expected.values())
        worst = max(np.abs(got_sd[k].detach().numpy() - expected[k]).max() for k in expected)
        assert worst <= 1e-5 * scale, (worst, scale)

    check(dict(model.named_parameters()), params_j)
    adam_j = state_j.inner_state[1 if weight_decay > 0 else 0]
    assert opt.count == int(adam_j.count) == int(state_j.count) == 2
    check(opt._moment("exp_avg"), adam_j.mu)
    check(opt._moment("exp_avg_sq"), adam_j.nu)
    if ema_decay:
        check(ema_params(opt), jtrain.ema_params(state_j))
    else:
        assert ema_params(opt) is None and jtrain.ema_params(state_j) is None


def test_eval_step_with_physics_metrics_matches_jax(pair, native_conv3d):
    pred, jpred = pair
    batch = make_batch(4, b=2)
    key = jax.random.key(9)
    j_step = jax.jit(jsteps.make_diffusion_eval_step(cost_name=COST, with_physics_metrics=True))
    expected = {k: float(v) for k, v in j_step(jpred, batch, key).items()}
    noise, t = jax_draws(key, 2)
    got = steps.make_diffusion_eval_step(cost_name=COST, with_physics_metrics=True)(
        pred, batch, noise=noise, t=t)
    assert set(got) == set(expected) and len(got) == 14
    for k, v in got.items():
        assert v.ndim == 0 and not v.requires_grad
        np.testing.assert_allclose(v.item(), expected[k], rtol=1e-4, atol=1e-7, err_msg=k)
    plain = steps.make_diffusion_eval_step(cost_name=COST)(pred, batch, noise=noise, t=t)
    assert set(plain) == {"val_loss"} and torch.equal(plain["val_loss"], got["val_loss"])


# ------------------------------------------------------------- train_trace()


def test_train_trace_routes_to_the_plain_versions(pair, monkeypatch):
    """Inside train_trace() the GroupNorm and attention calls that need a
    gradient never reach the K1/K2 wrappers: in a train step only the frozen
    encodes (E3D + E2D GroupNorms) do; calls without grad reach them as
    outside it. Outside it every call does again, also after an exception
    inside."""
    calls = []

    def record(name, fn):
        def wrapper(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(layers, "groupnorm_act", record("k1", layers.groupnorm_act))
    monkeypatch.setattr(layers, "fused_attention", record("k2", layers.fused_attention))
    pred = pair[0]
    batch = make_batch(5, b=1)
    noise, t = jax_draws(jax.random.key(0), 1)
    eval_step = steps.make_diffusion_eval_step(cost_name=COST)
    eval_step(pred, batch, noise=noise, t=t)
    outside = len(calls)
    assert calls.count("k2") == 2 and calls.count("k1") > 2 * 13
    with train_trace():
        assert layers.in_train_trace()
        eval_step(pred, batch, noise=noise, t=t)
    assert len(calls) == 2 * outside and not layers.in_train_trace()
    del calls[:]
    from diffusion_model_project_tpu_torch.losses.physics import PhysicsLoss

    train_step = steps.make_diffusion_train_step(GradCapture(pred.model), cost_name=COST,
                                                 physics=PhysicsLoss(0.1), lambda_velocity=0.1)
    encodes = sum(isinstance(m, GroupNorm) for enc in (pred.vae.encoder_3d, pred.vae.encoder_2d)
                  for m in enc.modules())
    pred.model.requires_grad_(True)
    try:
        train_step(pred, batch, noise=noise, t=t)
    finally:
        pred.model.requires_grad_(False)
        pred.model.zero_grad(set_to_none=True)
    assert calls == ["k1"] * encodes and encodes == 2 * 13
    del calls[:]
    with pytest.raises(RuntimeError):
        with train_trace():
            raise RuntimeError("inside")
    assert not layers.in_train_trace()
    eval_step(pred, batch, noise=noise, t=t)
    assert len(calls) == outside


def test_train_trace_groupnorm_is_two_pass():
    """At |mean| / std = 1e4 the one-pass statistics lose the variance; the
    two-pass ones inside train_trace() keep it (float64 reference)."""
    gen = torch.Generator().manual_seed(0)
    x = 1e4 + torch.randn((2, 8, 16, 16), generator=gen)
    norm = GroupNorm(1, 8, act="silu")
    xd = x.double().reshape(2, -1)
    ref = (xd - xd.mean(1, keepdim=True)) / torch.sqrt(xd.var(1, unbiased=False, keepdim=True)
                                                       + 1e-5)
    ref = torch.nn.functional.silu(ref).reshape(x.shape)
    with train_trace():
        inside = norm(x)
    outside = norm(x)
    assert (inside.double() - ref).abs().max() < 1e-3
    assert (outside.double() - ref).abs().max() > 1e-1


def test_train_step_runs_forward_and_backward_inside_train_trace(pair, monkeypatch):
    """torch.utils.checkpoint recomputes the decoder's blocks during backward:
    every plain two-pass GroupNorm call of the step (the UNet's and D3D's,
    which need a gradient), those of the recomputation included, sees the
    train_trace() flag."""
    seen = []
    plain = layers.group_norm

    def spy(*args, **kwargs):
        seen.append(layers.in_train_trace())
        return plain(*args, **kwargs)

    monkeypatch.setattr(layers, "group_norm", spy)
    pred = pair[0]
    from diffusion_model_project_tpu_torch.losses.physics import PhysicsLoss

    step = steps.make_diffusion_train_step(GradCapture(pred.model), physics=PhysicsLoss(0.1))
    pred.model.requires_grad_(True)
    try:
        step(pred, make_batch(6, b=1), torch.Generator().manual_seed(0))
    finally:
        pred.model.requires_grad_(False)
        pred.model.zero_grad(set_to_none=True)
    # the UNet and D3D forward, and D3D's 6 residual blocks (2 GroupNorms
    # each) once more in backward; the frozen encodes go to the K1 wrapper
    n_gn = lambda m: sum(isinstance(x, GroupNorm) for x in m.modules())  # noqa: E731
    assert len(seen) == n_gn(pred.model) + n_gn(pred.vae.decoder_3d) + 6 * 2 and all(seen)


# ------------------------------------------------------------ dropout repair


def test_dropout_is_the_identity_as_in_jax(tmp_path):
    """The JAX predictor never calls its UNet with train=True, so dropout > 0
    changes nothing: the port builds it and computes without it, and a run
    dir trained with '--dropout 0.1' loads."""
    kw = dict(UNET_KW, dropout=0.1)
    with_dropout = UNet(**kw)
    without = UNet(**UNET_KW)
    without.init_parameters_(torch.Generator().manual_seed(1))
    with_dropout.load_state_dict(without.state_dict(), strict=True)
    with_dropout.train()
    x = torch.randn((3, 2 * L + 1, 8, 8), generator=torch.Generator().manual_seed(2))
    t = torch.tensor([0, 5, 19])
    assert torch.equal(with_dropout(x, t), without(x, t))

    pred = port_predictor(seed=4, unet_kw=kw)
    (tmp_path / "vae").mkdir()
    torch.save(pred.vae.state_dict(), tmp_path / "vae" / "vae.pt")
    run = tmp_path / "20250101_unet_latent-diffusion_in-9-out-4-f-2-k-3-p-zeros-a-2..2-dr-0.1-x"
    run.mkdir()
    save_predictor(pred, str(run / "model.msgpack"))
    (run / "log.json").write_text(json.dumps({"params": {"training": {
        "predictor_type": "latent-diffusion",
        "predictor": {"model_name": "UNet", "model_kwargs": kw, "num_timesteps": T,
                      "vae_path": str(tmp_path / "vae")}}}}))
    loaded, params = predictor_from_directory(str(run), device="cpu")
    assert params["training"]["predictor"]["model_kwargs"]["dropout"] == 0.1
    assert loaded.model.dropout == 0.1
    for (k, a), b in zip(loaded.model.state_dict().items(), pred.model.state_dict().values()):
        assert torch.equal(a, b), k

"""The VAE trainers' steps (``training/accum.py``, ``train_vae_stage1.py``,
``train_vae_stage2.py``) against the JAX package, on the CPU in float32.

Tiny VAE networks (latent 4, widths (32, 32, 32), 3 slices of 16^2, B=2) are
built by the port with the JAX initializers from a seeded generator and
carried into the JAX package through its own importer (no flax init runs);
JAX's VAE is traced with native 3D convolutions, the same conv in another
summation order, to halve its compile. ``accumulate_clipped`` agrees within
1e-6 relative; the stage-1 loss and its gradients at one injected noise
within 1e-4 of max|JAX|; a stage-2 run of 5 microbatches with a NaN batch on
an accumulation boundary (accum 2, then the remainder step) has each
microbatch's gradient within 1e-4 of max|JAX|, and the weights, Adam's
moments and the accumulated gradient within 1e-5 of max|JAX| of JAX's train
and apply steps run on the port's gradients, after every microbatch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_model_project_tpu.data.dataset import NumpyLoader as JLoader
from diffusion_model_project_tpu.models.vae import DualBranchVAE as JDualVAE
from diffusion_model_project_tpu.training import accum as jaccum
from diffusion_model_project_tpu.training import train_vae_stage1 as js1
from diffusion_model_project_tpu.training import train_vae_stage2 as js2
from diffusion_model_project_tpu.utils import torch_import as ti

from diffusion_model_project_tpu_torch.models import vae as vae_mod
from diffusion_model_project_tpu_torch.models.layers import GroupNorm, routes_plain
from diffusion_model_project_tpu_torch.models.vae import DualBranchVAE
from diffusion_model_project_tpu_torch.training import accum
from diffusion_model_project_tpu_torch.training import train_vae_stage1 as s1
from diffusion_model_project_tpu_torch.training import train_vae_stage2 as s2
from diffusion_model_project_tpu_torch.utils.checkpoint import vae_params

from test_torch_train_step import native_conv3d, one_torch_thread  # noqa: F401

L, S, HW, B = 4, 3, 16, 2
FEATURES = (32, 32, 32)
LOSS = "normalized_mae_per_channel"


def _np(tree):
    """A numpy copy of a tree (a copy: JAX may alias a numpy array, and
    the port's optimizer updates its tensors in place)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.array(tree.detach() if isinstance(tree, torch.Tensor) else tree)


def _flat(tree) -> np.ndarray:
    """The leaves of a nested dict in sorted-key order, concatenated."""
    if isinstance(tree, dict):
        return np.concatenate([_flat(tree[k]) for k in sorted(tree)])
    return np.asarray(tree, np.float64).reshape(-1)


def _rel(port_tree, jax_tree) -> float:
    """max|port - JAX| / max|JAX| over the trees (max|port| where JAX is all 0)."""
    p, j = _flat(_np(port_tree)), _flat(_np(jax_tree))
    assert p.shape == j.shape
    scale = np.abs(j).max()
    return float(np.abs(p - j).max() / scale if scale else np.abs(p).max())


def _branch_sd(module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def vae_batch(seed, b=B, nan=False):
    rng = np.random.default_rng(seed)
    mask = (rng.random((b, 1, S, HW, HW)) > 0.3).astype(np.float32)
    v3d = rng.standard_normal((b, 3, S, HW, HW)).astype(np.float32)
    v2d = rng.standard_normal((b, 3, S, HW, HW)).astype(np.float32)
    v2d[:, 2] = 0.0
    if nan:
        v2d[0, 0, 1, 3, 5] = np.nan
    return {"velocity_2d": v2d, "mask_2d": mask, "velocity_3d": v3d, "mask_3d": mask}


def _torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


# ------------------------------------------------------------------ accum

@pytest.mark.parametrize("case", ["below", "above", "skip", "sequence"])
def test_accumulate_clipped_matches_jax(case):
    """Below the clip (plain accumulation), above it (rescaled to norm 1), a
    skipped NaN batch (unchanged, not re-clipped) and a sequence of four
    microbatches with a NaN one, against JAX ``accumulate_clipped``."""
    rng = np.random.default_rng(3)
    shapes = [(3, 4), (5,), (2, 3, 3), (7, 2)]
    scale = {"below": 1e-3, "above": 10.0, "skip": 10.0, "sequence": 0.5}[case]
    acc = [rng.standard_normal(s).astype(np.float32) * 0.01 for s in shapes]
    steps = []
    for k in range(4 if case == "sequence" else 1):
        g = [rng.standard_normal(s).astype(np.float32) * scale for s in shapes]
        keep = not (case == "skip" or (case == "sequence" and k == 2))
        if not keep:
            g[1][2] = np.nan
        steps.append((g, keep))
    j_acc = {str(i): jnp.asarray(a) for i, a in enumerate(acc)}
    p_acc = [torch.from_numpy(a.copy()) for a in acc]
    for g, keep in steps:
        j_acc = jaccum.accumulate_clipped(j_acc, {str(i): jnp.asarray(x) for i, x in enumerate(g)},
                                          keep, 3)
        p_acc = accum.accumulate_clipped(p_acc, [torch.from_numpy(x) for x in g],
                                         torch.tensor(keep), 3)
        for i, a in enumerate(p_acc):
            np.testing.assert_allclose(a.numpy(), np.asarray(j_acc[str(i)]), rtol=1e-6, atol=0)
    norm = float(np.sqrt(sum(float((a.double() ** 2).sum()) for a in p_acc)))
    if case == "below":
        for a, x, g in zip(p_acc, acc, steps[0][0]):
            np.testing.assert_allclose(a.numpy(), x + g / 3, rtol=1e-6)
        assert norm < 1.0
    elif case == "above":
        assert abs(norm - 1.0) < 1e-5
    elif case == "skip":
        for a, x in zip(p_acc, acc):
            np.testing.assert_array_equal(a.numpy(), x)


# ---------------------------------------------------------------- stage 1

def stage1_pair(seed=0):
    """The port's Stage1VAE and JAX's Stage1VAE with the same weights."""
    vae = s1.Stage1VAE(3, L, features=FEATURES)
    vae.init_parameters_(torch.Generator().manual_seed(seed))
    jparams = {"encoder_3d": ti.import_vae_encoder(_branch_sd(vae.encoder_3d)),
               "decoder_3d": ti.import_vae_decoder(_branch_sd(vae.decoder_3d))}
    return vae, js1.Stage1VAE(3, L, remat=True, features=FEATURES), jparams


def _stage1_batch(seed):
    b = vae_batch(seed)
    return {"velocity": b["velocity_3d"], "microstructure": b["mask_3d"]}


def test_stage1_loss_and_gradients_match_jax(native_conv3d):  # noqa: F811
    vae, jvae, jparams = stage1_pair()
    batch = _stage1_batch(1)
    key, kl_coeff = jax.random.key(5), 3e-3
    jlosses = js1.make_loss_fn(jvae, LOSS)

    def f(params):
        from diffusion_model_project_tpu.models.layers import train_trace
        with train_trace():
            return jax.value_and_grad(jlosses, has_aux=True)(
                params, {k: jnp.asarray(v) for k, v in batch.items()}, key, kl_coeff)

    (j_total, j_metrics), j_grads = jax.jit(f)(jparams)
    # JAX's noise: one normal draw of mu's (channels-last) shape from the key
    noise = jax.random.normal(key, (B, S, HW // 4, HW // 4, L), jnp.float32)
    noise = torch.from_numpy(np.moveaxis(np.asarray(noise), -1, 1).copy())

    opt = s1.AccumAdam(vae, 1e-4)
    losses = s1.make_loss_fn(vae, LOSS)
    from diffusion_model_project_tpu_torch.models.layers import train_trace
    with train_trace():
        total, metrics = losses(_torch(batch), kl_coeff, noise=noise)
        grads = torch.autograd.grad(total, opt.params)
    for name, p, j in (("total", total, j_total), ("recons", metrics["recons"],
                                                   j_metrics["recons"]),
                       ("kl", metrics["kl"], j_metrics["kl"]),
                       ("mu_absmax", metrics["mu_absmax"], j_metrics["mu_absmax"])):
        assert abs(float(p.detach()) - float(j)) <= 1e-4 * abs(float(j)), name
    assert not bool(metrics["bad"]) and not bool(j_metrics["bad"])
    assert _rel(opt._tree(grads), j_grads) <= 1e-4


def test_stage1_bad_batch_is_flagged_and_skipped():
    """A non-finite input makes mu non-finite: ``bad`` is set, the buffer
    stays as it was and no optimizer step runs on the boundary."""
    vae, _, _ = stage1_pair()
    opt = s1.AccumAdam(vae, 1e-3)
    train_step, _, _ = s1.make_steps(vae, LOSS, opt, accum_steps=1)
    batch = _torch(_stage1_batch(2))
    batch["velocity"][0, 1, 1, 2, 3] = float("nan")
    before = [p.detach().clone() for p in opt.params]
    metrics = train_step(batch, 1e-3, True, noise=torch.zeros(B, L, S, HW // 4, HW // 4))
    assert bool(metrics["bad"]) and opt.count == 0
    assert all(torch.equal(a, p) for a, p in zip(before, opt.params))
    assert all(not g.any() for g in opt.g_acc)


# ---------------------------------------------------------------- stage 2

def stage2_pair(seed=0):
    """The port's stage-2 VAE (E3D / D3D frozen, remat on E2D, D2D, D3D) and
    JAX's, with the same weights, split into trainable and frozen trees."""
    vae = DualBranchVAE(3, L, features=FEATURES)
    vae.init_parameters_(torch.Generator().manual_seed(seed))
    for name in s2.FROZEN:
        getattr(vae, name).requires_grad_(False)
    vae.encoder_2d.remat = vae.decoder_2d.remat = True
    jall = ti.import_dual_vae({k: v.detach().numpy().copy() for k, v in vae.state_dict().items()})
    jvae = JDualVAE(in_channels=3, latent_channels=L, remat_encoders=True, remat_decoders=True,
                    features=FEATURES)
    return (vae, jvae, {k: jall[k] for k in s2.TRAINABLE}, {k: jall[k] for k in s2.FROZEN})


def test_stage2_steps_with_a_nan_batch_match_jax(native_conv3d, monkeypatch):  # noqa: F811
    """5 microbatches, accum 2, the NaN batch on the second boundary (i=3):
    the step there is suppressed, batch 4 accumulates onto the carried
    window, and the end-of-epoch remainder step applies it.

    Each microbatch's metrics and gradient are held to JAX's loss at the
    same weights (1e-4 relative; the gradient within 1e-4 of max|JAX|).
    JAX's train and apply steps (``make_steps``: the skip-aware
    accumulation, the step-on-boundary ``lax.cond``, ``optax.adam``) run on
    the port's gradients, through a loss linear in the trainable weights
    whose gradient is the port's exactly; after every microbatch and after
    the remainder step the port's weights, Adam's count, mu and nu and the
    accumulated gradient are within 1e-5 of max|JAX|.

    The two packages' own gradients are not chained through Adam: its first
    steps move a weight by lr * g / (|g| + 1e-8), which turns a rounding
    difference d in a near-zero gradient into up to lr * d / 1e-8. The conv
    biases in front of a GroupNorm of one channel a group have a gradient of
    0 up to rounding, so at lr 1e-3 the weights part by up to about lr after
    one step (measured 1.1e-3 of max|param| at widths 32, 7.2e-4 at 64), and every
    later gradient is taken at other weights."""
    lr, la, lc, accum_steps = 1e-3, 5.0, 50.0, 2
    vae, jvae, trainable, frozen = stage2_pair()
    real_loss = js2.make_loss_fn(jvae, LOSS, la, lc)

    def jgrad(params, batch):
        from diffusion_model_project_tpu.models.layers import train_trace
        with train_trace():
            return jax.value_and_grad(real_loss, has_aux=True)(params, frozen, batch)

    jgrad = jax.jit(jgrad)

    def linear_loss_fn(*_):
        def losses(trainable, frozen, batch):
            total = sum(jnp.sum(t * g) for t, g in zip(jax.tree_util.tree_leaves(trainable),
                                                       jax.tree_util.tree_leaves(batch["grads"])))
            return total, {"bad": batch["bad"]}
        return losses

    monkeypatch.setattr(js2, "make_loss_fn", linear_loss_fn)
    optimizer = optax.adam(lr)
    opt_state = optimizer.init(trainable)
    g_acc = jax.tree_util.tree_map(jnp.zeros_like, trainable)
    j_train, j_apply, _ = js2.make_steps(jvae, LOSS, optimizer, la, lc, accum_steps=accum_steps)

    opt = s1.AccumAdam(vae, lr)
    assert set(n.split(".")[0] for n in opt.names) == set(s2.TRAINABLE)
    captured = {}
    real_accumulate = opt.accumulate

    def accumulate(grads, keep, steps):
        captured["grads"] = [g.detach().clone() for g in grads]
        real_accumulate(grads, keep, steps)

    opt.accumulate = accumulate
    p_train, p_apply, _ = s2.make_steps(vae, LOSS, opt, la, lc, accum_steps=accum_steps)

    def check(where):
        st = opt.state_tree()["0"]
        assert int(st["count"]) == int(opt_state[0].count), where
        for name, p, j in (("params", vae_params(vae, s2.TRAINABLE), trainable),
                           ("mu", st["mu"], opt_state[0].mu), ("nu", st["nu"], opt_state[0].nu),
                           ("g_acc", opt.g_acc_tree(), g_acc)):
            assert _rel(p, j) <= 1e-5, f"{name} after {where}"

    for i in range(5):
        batch = vae_batch(10 + i, nan=i == 3)
        boundary = (i + 1) % accum_steps == 0
        (_, jm), jg = jgrad(jax.tree_util.tree_map(jnp.asarray, _np(vae_params(vae, s2.TRAINABLE))),
                            {k: jnp.asarray(v) for k, v in batch.items()})
        pm = p_train(_torch(batch), boundary)
        grads = _np(opt._tree(captured["grads"]))
        assert bool(pm["bad"]) == bool(jm["bad"]) == (i == 3)
        if i != 3:
            for k in ("recons_2d", "align", "cross"):
                assert abs(float(pm[k]) - float(jm[k])) <= 1e-4 * abs(float(jm[k])), (i, k)
            assert _rel(grads, jg) <= 1e-4, f"gradient of microbatch {i}"
        trainable, opt_state, g_acc, _ = j_train(
            trainable, opt_state, g_acc, frozen,
            {"grads": jax.tree_util.tree_map(jnp.asarray, grads), "bad": jnp.asarray(i == 3)},
            boundary)
        check(f"microbatch {i}")
    assert opt.count == 1
    trainable, opt_state = j_apply(trainable, opt_state, g_acc)
    g_acc = jax.tree_util.tree_map(jnp.zeros_like, g_acc)
    p_apply()
    assert opt.count == 2
    check("the remainder step")


def test_kernel_routing_and_remat_of_the_steps(monkeypatch):
    """Where K1 launches on the card: the GroupNorm calls the wrappers take
    (``routes_plain`` false), counted by a hook on the CPU, equal the module
    counts: 0 in a stage-1 train microbatch, 26 a stage-1
    validation batch (E3D + D3D), 13 in a stage-2 microbatch (the frozen E3D
    encode) and 52 a stage-2 validation batch. Only blocks that need a
    gradient are checkpointed: 12 in stage 1, 18 in stage 2 (E2D, D2D, D3D;
    the frozen encode none)."""
    counts = {"kernel": 0, "plain": 0, "checkpoint": 0}

    def hook(mod, args):
        counts["plain" if routes_plain(mod, args[0]) else "kernel"] += 1

    real = vae_mod.checkpoint

    def counted(*a, **kw):
        counts["checkpoint"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(vae_mod, "checkpoint", counted)
    handle = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda mod, args: hook(mod, args) if isinstance(mod, GroupNorm) else None)
    try:
        def run(fn):
            for k in counts:
                counts[k] = 0
            fn()
            return dict(counts)

        vae1, _, _ = stage1_pair()
        t1, _, e1 = s1.make_steps(vae1, LOSS, s1.AccumAdam(vae1, 1e-4), accum_steps=2)
        b1 = _torch(_stage1_batch(4))
        gen = torch.Generator().manual_seed(0)
        assert run(lambda: t1(b1, 1e-3, False, generator=gen)) == \
            {"kernel": 0, "plain": 26 + 24, "checkpoint": 12}  # + 24 recomputed
        assert run(lambda: e1(b1, 1e-3, generator=gen)) == \
            {"kernel": 26, "plain": 0, "checkpoint": 0}

        vae2, _, _, _ = stage2_pair()
        vae2.decoder_3d.remat = True
        t2, _, e2 = s2.make_steps(vae2, LOSS, s1.AccumAdam(vae2, 1e-4), 5.0, 50.0, accum_steps=2)
        b2 = _torch(vae_batch(5))
        got = run(lambda: t2(b2, False))
        assert got["kernel"] == 13 and got["checkpoint"] == 18, got
        assert run(lambda: e2(b2)) == {"kernel": 52, "plain": 0, "checkpoint": 0}
    finally:
        handle.remove()


# ---------------------------------------------------- host-side helpers

def test_split_order_norm_factors_and_metric_scans_match_jax():
    for n, sizes, seed in ((8, (5, 1, 2), 2024), (12, (8, 1, 3), 7)):
        assert s1.torch_random_split_indices(n, sizes, seed) == \
            js1.torch_random_split_indices(n, sizes, seed)

    class Idx:
        def __len__(self):
            return 11

        def __getitem__(self, i):
            return {"x": np.asarray([i], np.int64)}

    loader = JLoader(Idx(), batch_size=3, shuffle=True, seed=2024)
    for epoch in (0, 2, 5):
        loader.set_epoch(epoch)
        seen = np.concatenate([b["x"][:, 0] for b in loader])
        np.testing.assert_array_equal(s1.loader_shuffle_order(11, 2024, epoch, True), seen)
    np.testing.assert_array_equal(s1.loader_shuffle_order(5, 1, 1, False), np.arange(5))

    stats = {"U_per_component": {"max_u": 2.0, "max_v": 1.0, "max_w": 0.5, "mean_u": 0.2,
                                 "mean_v": 0.1, "mean_w": 0.05},
             "U_2d_per_component": {"max_u": 3.0, "max_v": 0.5, "max_w": 0.0},
             "U": {"max": 2.0}, "U_2d": {"max": 3.0}}
    for st in (stats, {"U": {"max": 2.0}, "U_2d": {"max": 3.0}}, {"U": {"max": 2.0}}):
        for mode in ("max", "mean"):
            np.testing.assert_array_equal(s1.norm_factors_from_stats(st, mode),
                                          js1.norm_factors_from_stats(st, mode))

    m1 = [{"bad": False, "kl": 1.0, "recons": 0.5}, {"bad": True, "kl": float("nan"),
                                                      "recons": 9.0},
          {"bad": False, "kl": 2e3, "recons": 0.1}, {"bad": False, "kl": 3.0, "recons": 0.2}]
    assert s1.scan_train_metrics(m1) == js1.scan_train_metrics(m1) == (0.5, 1.0, [1], 2e3)
    assert s1.scan_train_metrics(m1[:2]) == js1.scan_train_metrics(m1[:2])
    m2 = [{"bad": b, "recons_2d": 1.0 + i, "align": 0.1, "cross": 2.0, "kl_2d": 0.0}
          for i, b in enumerate((False, True, False))]
    assert s2.scan_train_metrics(m2) == js2.scan_train_metrics(m2)
    metrics = [{"bad": torch.tensor(i == 1), "kl": torch.tensor(float(i))} for i in range(3)]
    assert s1.fetch_metrics(metrics) == [{"bad": i == 1, "kl": float(i)} for i in range(3)]


def test_paired_dataset_and_checksum():
    class Base:
        def __getitem__(self, idx):
            return {"velocity": np.full((3, 1, 2, 2), idx, np.float32),
                    "microstructure": np.ones((1, 1, 2, 2), np.float32),
                    "original_idx": np.asarray(idx % 4)}

        def set_epoch(self, epoch):
            pass

    ds = s2.PairedDataset(Base(), [(1, 5), (2, 3)])
    item = ds[0]
    assert item["velocity_2d"][0, 0, 0, 0] == 1 and item["velocity_3d"][0, 0, 0, 0] == 5
    with pytest.raises(AssertionError, match="Pairing mismatch"):
        ds[1]
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(0.5)
        lin.bias.fill_(-1.0)
    assert s2.checksum(lin) == 1.0

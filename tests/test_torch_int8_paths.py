"""The port's int8 predictors (``with_vae_int8`` / ``with_unet_int8``), the
train steps' int8 refusals and the export of an int8 sampler, on the CPU,
against the JAX package.

A tiny predictor at ``tests/test_quant.py``'s size (3 x 32^2 volumes, VAE
(32, 64, 64), T=20) with a UNet whose convs reach the int8 path (in 17 ->
(32, 64), as JAX's ``test_unet_int8_survives_pytree_and_engages``) is built
by the port with the JAX initializers and carried into a JAX predictor
through the JAX package's importer. ``predict_ddim(5)`` with both int8 flags
on: each flag engages, the float paths agree, the port's own
int8-against-float32 spread is within a factor 2 of JAX's, and the port's
int8 result lies within 2.5 x JAX's spread of JAX's (two independent int8
errors of one size are 2 x apart). An int8 network holds no tighter rule
against another implementation: an ulp of difference ahead of a quantizer
(a GroupNorm summed in another order; XLA's jitted scales are ``amax *
(1/127)``, the port's and JAX's eager ones ``amax / 127``) flips a code now
and then, a flip moves the next quantizer's inputs by a sizeable fraction of
a step, and a few int8 layers later two runs carry independent rounding
noise. ``tests/test_torch_quant.py`` holds the convs themselves equal to
JAX's, bit for bit, at equal inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_project_tpu.diffusion.predictor import LatentDiffusionPredictor as JP
from diffusion_model_project_tpu.diffusion.scheduler import DiffusionScheduler as JScheduler
from diffusion_model_project_tpu.models.unet import UNet as JUNet
from diffusion_model_project_tpu.models.vae import DualBranchVAE as JVAE
from diffusion_model_project_tpu.ops.normalizer import MaxNormalizer as JNorm
from diffusion_model_project_tpu.utils import torch_import as ti

from diffusion_model_project_tpu_torch.diffusion.predictor import LatentDiffusionPredictor
from diffusion_model_project_tpu_torch.models import layers
from diffusion_model_project_tpu_torch.ops.cuda import int8_conv as k4
from diffusion_model_project_tpu_torch.training import steps
from diffusion_model_project_tpu_torch.utils import export

from test_torch_train_step import one_torch_thread  # noqa: F401

L, S, HW, T, STEPS = 8, 3, 32, 20, 5
UNET_KW = dict(in_channels=2 * L + 1, out_channels=L, features=(32, 64), kernel_size=3,
               padding_mode="zeros", activation="silu", final_activation=None, attention="",
               dropout=0.0, time_embedding_dim=16)
VAE_FEATURES = (32, 64, 64)
NORM_OUTPUT = [2.0, 3.0, 4.0]


@pytest.fixture(scope="module")
def pred():
    p = LatentDiffusionPredictor.create(dict(UNET_KW), seed=11, device="cpu", num_timesteps=T,
                                        latent_channels=L, vae_features=VAE_FEATURES)
    gen = torch.Generator().manual_seed(12)  # final_conv is zero at init
    with torch.no_grad():
        w = p.model.final_conv.weight
        w.copy_(torch.randn(w.shape, generator=gen) * 0.05)
    return p.set_normalizer({"input": [1.0], "output": NORM_OUTPUT})


def _np(sd):
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


def _inputs(seed=3):
    r = np.random.default_rng(seed)
    img = (r.random((1, S, 1, HW, HW)) > 0.3).astype(np.float32)
    img[:, :, :, 0, 0] = 0.0
    v2d = r.standard_normal((1, S, 3, HW, HW)).astype(np.float32)
    noise = r.standard_normal((S, L, HW // 4, HW // 4)).astype(np.float32)
    return img, v2d, noise


def _rel_mse(a, b):
    return float(np.mean((a - b) ** 2) / (np.mean(b ** 2) + 1e-12))


def test_with_int8_shares_modules_and_leaves_the_original(pred):
    p8 = pred.with_vae_int8().with_unet_int8()
    assert (pred.vae_int8, pred.unet_int8) == (False, False)
    assert (p8.vae_int8, p8.unet_int8) == (True, True)
    assert pred.with_vae_int8(False).vae_int8 is False
    assert p8.model is pred.model and p8.vae is pred.vae
    sd, sd8 = pred.state_dict(), p8.state_dict()
    assert list(sd) == list(sd8)
    assert all(sd[k].data_ptr() == sd8[k].data_ptr() for k in sd)
    # int8 adds no parameter: a strict load of the original's weights works
    p8.load_state_dict(sd, strict=True)
    assert p8.uses_distance_transform() == pred.uses_distance_transform()


def test_int8_predict_ddim_matches_jax(pred):
    img, v2d, noise = _inputs()
    kw = dict(num_steps=STEPS, noise=torch.from_numpy(noise))
    i, v = torch.from_numpy(img), torch.from_numpy(v2d)
    out = {}
    for name, p in (("f32", pred), ("vae", pred.with_vae_int8()),
                    ("unet", pred.with_unet_int8()),
                    ("both", pred.with_vae_int8().with_unet_int8())):
        before = k4.LAUNCHES
        out[name] = p.predict_ddim(i, v, **kw).numpy()
        assert k4.LAUNCHES == before  # CPU tensors take the plain version
    assert np.isfinite(out["both"]).all()
    for name in ("vae", "unet", "both"):  # the int8 path engages
        assert not np.array_equal(out[name], out["f32"]), name

    jp = JP(unet=JUNet(**dict(UNET_KW, features=tuple(UNET_KW["features"]))),
            vae=JVAE(latent_channels=L, features=VAE_FEATURES), num_slices=S,
            num_timesteps=T, distance_transform=True,
            unet_params=ti.import_unet(_np(pred.model.state_dict()),
                                       num_levels=len(UNET_KW["features"])),
            vae_params=ti.import_dual_vae(_np(pred.vae.state_dict())),
            scheduler=JScheduler.create(T), norm_input=JNorm([1.0]),
            norm_output=JNorm(NORM_OUTPUT))
    jp8 = jp.with_vae_int8().with_unet_int8()
    args = (jnp.asarray(img), jnp.asarray(v2d), jnp.asarray(noise))

    def run(p):
        return p.predict_ddim(*args[:2], num_steps=STEPS, eta=0.0, noise=args[2])

    j_f32, j_int8 = np.asarray(jax.jit(run)(jp)), np.asarray(jax.jit(run)(jp8))
    assert _rel_mse(out["f32"], j_f32) <= 1e-6  # the float paths agree
    jax_spread, port_spread = _rel_mse(j_int8, j_f32), _rel_mse(out["both"], out["f32"])
    port_vs_jax = _rel_mse(out["both"], j_int8)
    print(f"int8 vs float32: JAX {jax_spread:.3e}, port {port_spread:.3e}; port vs JAX "
          f"{port_vs_jax:.3e}")
    assert 0.5 * jax_spread <= port_spread <= 2 * jax_spread
    assert 0 < port_vs_jax <= 2.5 * jax_spread


@pytest.mark.parametrize("kind", ["diffusion", "cached_latent"])
def test_train_steps_refuse_an_int8_predictor(pred, kind):
    opt = torch.optim.Adam(pred.model.parameters(), lr=1e-4)
    make = {"diffusion": steps.make_diffusion_train_step,
            "cached_latent": steps.make_cached_latent_train_step}[kind]
    step = make(opt)
    for p8 in (pred.with_vae_int8(), pred.with_unet_int8()):
        with pytest.raises(ValueError, match="int8"):
            step(p8, {})


def test_exported_int8_sampler_equals_eager(pred):
    p8 = pred.with_vae_int8().with_unet_int8()
    img, v2d, noise = _inputs(seed=4)
    args = (torch.from_numpy(img), torch.from_numpy(v2d), torch.from_numpy(noise))
    ep = export.export_program(p8, batch=1, num_steps=1, image_hw=(HW, HW), num_slices=S)
    ops = [n for n in ep.graph.nodes if n.op == "call_function"
           and n.target is torch.ops.dm_port.int8_conv.default]

    def int8_convs(module):
        return sum(not layers.use_float_path(m.in_channels, m.out_channels)
                   for m in module.modules() if isinstance(m, (layers.Conv2d, layers.Conv3d)))

    # E2D, the UNet at the one step, D3D
    n_convs = (int8_convs(pred.vae.encoder_2d) + int8_convs(pred.model)
               + int8_convs(pred.vae.decoder_3d))
    assert len(ops) == n_convs > 0
    with torch.inference_mode():
        got = ep.module()(*args)
    want = p8.predict_ddim(args[0], args[1], num_steps=1, noise=args[2])
    assert torch.equal(got, want)
    assert not layers.in_int8_convs()

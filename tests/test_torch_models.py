"""The port's UNet and dual-branch VAE against the JAX package's, on the CPU.

Random-init JAX params are carried across with the port's
``utils/weights.py`` and loaded with ``strict=True``; inputs come from a
seeded numpy generator. JAX zero-initializes ``final_conv`` and the
attention ``proj_out``, which would make the UNet output identically 0 and
hide the attention path, so both get random weights first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_project_tpu.models.unet import UNet as JUNet
from diffusion_model_project_tpu.models.vae import DualBranchVAE as JDualBranchVAE

from diffusion_model_project_tpu_torch.models.unet import UNet
from diffusion_model_project_tpu_torch.models.vae import DualBranchVAE
from diffusion_model_project_tpu_torch.utils import weights

from test_torch_train_step import one_torch_thread  # noqa: F401


def _np_tree(params):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), params)


def randomize_zero_inits(unet_params: dict, rng) -> dict:
    """Give final_conv and every proj_out random weights (both zero at init)."""
    params = _np_tree(unet_params)
    for name, sub in params.items():
        if name == "final_conv":
            sub["weight"] = (rng.standard_normal(sub["weight"].shape) * 0.05).astype(np.float32)
            sub["bias"] = (rng.standard_normal(sub["bias"].shape) * 0.05).astype(np.float32)
        elif name.endswith("_attn"):
            sub["proj_out_weight"] = (rng.standard_normal(sub["proj_out_weight"].shape)
                                      * 0.1).astype(np.float32)
            sub["proj_out_bias"] = (rng.standard_normal(sub["proj_out_bias"].shape)
                                    * 0.05).astype(np.float32)
    return params


def _unet_kwargs(attention, padding_mode):
    return dict(in_channels=9, out_channels=4, features=(16, 32, 64), kernel_size=3,
                padding_mode=padding_mode, activation="silu", final_activation=None,
                attention=attention, dropout=0.0, time_embedding_dim=16)


@pytest.mark.parametrize("padding_mode", ["zeros", "reflect"])
@pytest.mark.parametrize("attention", ["", "2..2"])
def test_unet_matches_jax(rng, attention, padding_mode):
    kw = _unet_kwargs(attention, padding_mode)
    x = rng.standard_normal((2, 16, 16, 9)).astype(np.float32)
    t = np.array([3, 711], np.int32)
    junet = JUNet(**kw)
    params = junet.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(t))["params"]
    params = randomize_zero_inits(params, rng)
    expected = np.asarray(junet.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))

    unet = UNet(**kw)
    unet.load_state_dict(weights.to_tensors(weights.export_unet(params)), strict=True)
    with torch.inference_mode():
        got = unet(torch.from_numpy(np.moveaxis(x, -1, 1).copy()), torch.from_numpy(t).long())
    assert np.abs(expected).max() > 1e-2  # the output path is live
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), expected, rtol=1e-4, atol=1e-5)


def test_vae_encodes_and_decodes_match_jax(rng):
    jvae = JDualBranchVAE(latent_channels=4, features=(32, 32, 32))
    v = rng.standard_normal((2, 3, 16, 16, 3)).astype(np.float32)
    z = rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32)
    params = _np_tree(jvae.init({"params": jax.random.key(1), "sample": jax.random.key(2)},
                                jnp.asarray(v), jnp.asarray(v))["params"])
    apply = lambda a, method: jvae.apply({"params": params}, jnp.asarray(a), method=method)
    mu_j, (_, logvar_j) = apply(v, "encode_2d_deterministic")
    mu3_j, _ = apply(v, "encode_3d_deterministic")
    dec_j, dec2_j = apply(z, "decode_3d"), apply(z, "decode_2d")

    vae = DualBranchVAE(latent_channels=4, features=(32, 32, 32))
    vae.load_state_dict(weights.to_tensors(weights.export_dual_vae(params)), strict=True)
    to_cf = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))
    to_cl = lambda t: np.moveaxis(t.numpy(), 1, -1)
    with torch.inference_mode():
        mu, (_, logvar) = vae.encode_2d_deterministic(to_cf(v))
        mu3, _ = vae.encode_3d_deterministic(to_cf(v))
        dec, dec2 = vae.decode_3d(to_cf(z)), vae.decode_2d(to_cf(z))
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_cl(mu), np.asarray(mu_j), **tol)
    np.testing.assert_allclose(to_cl(logvar), np.asarray(logvar_j), **tol)
    np.testing.assert_allclose(to_cl(mu3), np.asarray(mu3_j), **tol)
    np.testing.assert_allclose(to_cl(dec), np.asarray(dec_j), **tol)
    np.testing.assert_allclose(to_cl(dec2), np.asarray(dec2_j), **tol)

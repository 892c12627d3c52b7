"""The port's FiLM-conditioned VAE against the JAX package's, on the CPU.

JAX ``DualBranchVAE(conditional=True)`` params (FiLM weights perturbed
by random values, since at init FiLM is close to the identity) are carried into the
port with ``utils/weights.py`` and loaded with ``strict=True``; the encodes
and decodes of both branches (condition 0 on the 2D branch, 1 on the 3D
branch) are compared at the VAE tolerance of ``tests/test_torch_models.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_project_tpu.models.vae import (
    DualBranchVAE as JDualBranchVAE, FiLM as JFiLM)

from diffusion_model_project_tpu_torch.models.vae import DualBranchVAE, FiLM
from diffusion_model_project_tpu_torch.utils import weights

from test_torch_train_step import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)
LATENT = 4


def _np_tree(params):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), params)


def randomize_films(tree, rng):
    """Every FiLM leaf (under a key starting 'film') plus N(0, 0.05^2) noise:
    gamma stays about 1, so the GroupNorms after it see features of the
    usual spread. (At 0.2 the encoder's float32 rounding grows to 3.7e-5 of
    1.8 in the JAX package and 1.6e-5 in the port, each against the port in
    float64: past rtol 1e-4 / atol 1e-5 on both sides.)"""
    def walk(node, in_film):
        if not isinstance(node, dict):
            return ((node + rng.standard_normal(node.shape) * 0.05).astype(np.float32)
                    if in_film else node)
        return {k: walk(v, in_film or k.startswith("film")) for k, v in node.items()}
    return walk(tree, False)


def to_cf(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def to_cl(t):
    return np.moveaxis(t.numpy(), 1, -1)


def test_film_matches_jax(rng):
    x = rng.standard_normal((3, 2, 4, 4, 32)).astype(np.float32)
    cond = np.array([0.0, 1.0, 1.0], np.float32)
    jfilm = JFiLM(32)
    params = _np_tree(jfilm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(cond))["params"])
    params = randomize_films({"film": params}, rng)["film"]
    expected = np.asarray(jfilm.apply({"params": params}, jnp.asarray(x), jnp.asarray(cond)))

    film = FiLM(32)
    sd = {}
    weights._film(params, "film", sd)
    film.load_state_dict({k[len("film."):]: v for k, v in weights.to_tensors(sd).items()},
                         strict=True)
    with torch.inference_mode():
        got = film(to_cf(x), torch.from_numpy(cond))
    np.testing.assert_allclose(to_cl(got), expected, **TOL)


def test_film_init_is_near_identity():
    # the JAX package's init: gamma half of the last bias at 1, beta at 0,
    # last weight xavier-uniform with gain 0.1
    vae = DualBranchVAE(latent_channels=LATENT, features=(32, 32, 32), conditional=True)
    vae.init_parameters_(torch.Generator().manual_seed(0))
    film = vae.encoder_2d.res1_1.film1
    last = film.mlp[4]
    assert torch.equal(last.bias[:32], torch.ones(32))
    assert torch.equal(last.bias[32:], torch.zeros(32))
    bound = (3.0 * 0.01 / ((128 + 64) / 2)) ** 0.5
    assert 0.5 * bound < last.weight.abs().max() <= bound


@pytest.fixture(scope="module")
def conditional_vae():
    rng = np.random.default_rng(7)
    jvae = JDualBranchVAE(latent_channels=LATENT, features=(32, 32, 32), conditional=True)
    v = rng.standard_normal((2, 3, 16, 16, 3)).astype(np.float32)
    params = _np_tree(jvae.init({"params": jax.random.key(1), "sample": jax.random.key(2)},
                                jnp.asarray(v), jnp.asarray(v))["params"])
    return jvae, randomize_films(params, rng)


def test_conditional_state_dict_keys_are_the_references(conditional_vae):
    _, params = conditional_vae
    vae = DualBranchVAE(latent_channels=LATENT, features=(32, 32, 32), conditional=True)
    sd = weights.export_dual_vae(params)
    assert set(vae.state_dict()) == set(sd)
    for key in ("encoder_2d.film_in.mlp.0.weight", "encoder_3d.film_out.mlp.4.bias",
                "decoder_3d.film_pre_out.mlp.2.weight", "decoder_2d.res2_1.film2.mlp.4.weight",
                "encoder_2d.res1_1.film1.mlp.0.bias"):
        assert key in sd
    # an unconditional VAE refuses the conditional checkpoint
    with pytest.raises(RuntimeError, match="Unexpected key"):
        DualBranchVAE(latent_channels=LATENT, features=(32, 32, 32)).load_state_dict(
            weights.to_tensors(sd), strict=True)


@pytest.mark.parametrize("method", ["encode_2d_deterministic", "encode_3d_deterministic",
                                    "decode_2d", "decode_3d"])
def test_conditional_vae_matches_jax(conditional_vae, method):
    jvae, params = conditional_vae
    rng = np.random.default_rng(8)
    encode = method.startswith("encode")
    shape = (2, 3, 16, 16, 3) if encode else (2, 3, 4, 4, LATENT)
    x = rng.standard_normal(shape).astype(np.float32)
    out_j = jvae.apply({"params": params}, jnp.asarray(x), method=method)

    vae = DualBranchVAE(latent_channels=LATENT, features=(32, 32, 32), conditional=True)
    vae.load_state_dict(weights.to_tensors(weights.export_dual_vae(params)), strict=True)
    with torch.inference_mode():
        out = getattr(vae, method)(to_cf(x))
    if encode:
        mu, (_, logvar) = out
        mu_j, (_, logvar_j) = out_j
        np.testing.assert_allclose(to_cl(mu), np.asarray(mu_j), **TOL)
        np.testing.assert_allclose(to_cl(logvar), np.asarray(logvar_j), **TOL)
    else:
        expected = np.asarray(out_j)
        np.testing.assert_allclose(to_cl(out), expected, **TOL)
        if method == "decode_2d":
            assert not expected[..., 2].any()
    # the condition matters: the other branch's constant gives other numbers
    branch = getattr(vae, ("encoder_" if encode else "decoder_") + method.split("_")[1])
    other = torch.full((2,), 0.0 if "3d" in method else 1.0)
    with torch.inference_mode():
        flipped = branch(to_cf(x), other)
    first = lambda o: o[0] if encode else o  # noqa: E731
    assert not torch.allclose(first(flipped), first(out), rtol=1e-3, atol=1e-4)


def test_conditional_encoder_requires_its_condition():
    from diffusion_model_project_tpu_torch.models.vae import Encoder

    enc = Encoder(3, LATENT, features=(32, 32, 32), conditional=True)
    x = torch.zeros((1, 3, 2, 8, 8))
    with pytest.raises(ValueError, match="requires a condition"):
        enc(x)
    with pytest.raises(ValueError, match="conditional=False"):
        Encoder(3, LATENT, features=(32, 32, 32))(x, torch.zeros(1))

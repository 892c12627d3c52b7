"""The PyTorch port's ops against the JAX package's, on the CPU in float32.

Inputs come from a seeded numpy generator and go to both sides; the JAX side
is channels-last, the port channels-first. GroupNorm and attention are also
held against the Pallas kernels run in interpret mode. The kernels
themselves are checked on the card by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from diffusion_model_project_tpu.ops import basic as jbasic
from diffusion_model_project_tpu.ops.attention import multihead_attention as j_mha
from diffusion_model_project_tpu.ops.distance import distance_transform_edt as j_edt
from diffusion_model_project_tpu.ops.normalizer import MaxNormalizer as JMaxNormalizer
from diffusion_model_project_tpu.ops import resize as jresize
from diffusion_model_project_tpu.ops.pallas import fused_attention as j_fused_attention
from diffusion_model_project_tpu.ops.pallas import fused_groupnorm_act as j_fused_gn

from diffusion_model_project_tpu_torch.ops import basic as tbasic
from diffusion_model_project_tpu_torch.ops import resize as tresize
from diffusion_model_project_tpu_torch.ops.attention import multihead_attention as t_mha
from diffusion_model_project_tpu_torch.ops.cuda import attention as k2
from diffusion_model_project_tpu_torch.ops.cuda import groupnorm_act as k1
from diffusion_model_project_tpu_torch.ops.distance import distance_transform_edt as t_edt
from diffusion_model_project_tpu_torch.ops.normalizer import MaxNormalizer as TMaxNormalizer


def _cf(x_cl: np.ndarray) -> torch.Tensor:
    """channels-last numpy -> channels-first torch."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x_cl, -1, 1)))


def _cl(x_cf: torch.Tensor) -> np.ndarray:
    return np.moveaxis(x_cf.numpy(), 1, -1)


def _gn_inputs(rng, groups, spatial):
    c = 64
    x = (rng.standard_normal((2, *spatial, c)) * 1.5 + 0.3).astype(np.float32)
    w = rng.standard_normal(c).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("spatial", [(8, 8), (3, 8, 8)])
@pytest.mark.parametrize("act", ["", "silu", "relu"])
@pytest.mark.parametrize("groups", [1, 32])
def test_group_norm_plain_matches_jax(rng, monkeypatch, groups, act, spatial):
    x, w, b = _gn_inputs(rng, groups, spatial)
    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    tx, tw, tb = _cf(x), torch.from_numpy(w), torch.from_numpy(b)
    act_j = jbasic.activation_function(act)
    act_t = tbasic.activation_function(act)

    one_pass = act_j(jbasic.group_norm(jx, jw, jb, groups))
    monkeypatch.setattr(jbasic, "GN_TWO_PASS", True)
    two_pass = act_j(jbasic.group_norm(jx, jw, jb, groups))
    pallas = j_fused_gn(jx, jw, jb, groups, act=act, interpret=True)

    got_one = _cl(act_t(tbasic.group_norm(tx, tw, tb, groups)))
    got_two = _cl(act_t(tbasic.group_norm(tx, tw, tb, groups, two_pass=True)))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_one, np.asarray(one_pass), **tol)
    np.testing.assert_allclose(got_two, np.asarray(two_pass), **tol)
    np.testing.assert_allclose(got_one, np.asarray(pallas), **tol)
    # the K1 wrapper on a CPU tensor is the plain version
    np.testing.assert_allclose(_cl(k1.groupnorm_act(tx, tw, tb, groups, act)),
                               np.asarray(pallas), **tol)


def _attn_inputs(rng, tokens, embed):
    x = rng.standard_normal((3, tokens, embed)).astype(np.float32)
    w_qkv = (rng.standard_normal((embed, 3 * embed)) * 0.1).astype(np.float32)
    b_qkv = (rng.standard_normal(3 * embed) * 0.05).astype(np.float32)
    w_out = (rng.standard_normal((embed, embed)) * 0.1).astype(np.float32)
    b_out = (rng.standard_normal(embed) * 0.05).astype(np.float32)
    return x, w_qkv, b_qkv, w_out, b_out


@pytest.mark.parametrize("head_dim", [16, 32])
def test_attention_plain_matches_jax(rng, head_dim):
    heads, tokens = 2, 16
    arrays = _attn_inputs(rng, tokens, heads * head_dim)
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [torch.from_numpy(a) for a in arrays]
    xla = np.asarray(j_mha(*jargs, num_heads=heads))
    pallas = np.asarray(j_fused_attention(*jargs, num_heads=heads, interpret=True))
    got = t_mha(*targs, num_heads=heads).numpy()
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, xla, **tol)
    np.testing.assert_allclose(got, pallas, **tol)
    np.testing.assert_allclose(k2.fused_attention(*targs, num_heads=heads).numpy(), pallas, **tol)


def _masks(rng):
    img = (rng.random((4, 32, 32)) > 0.35).astype(np.float32)
    img[1] = 1.0                        # all-fluid slice: the hypot(H, W) clamp
    img[2] = 1.0
    img[2, 5, 30] = 0.0                 # a single solid pixel
    return img


def test_edt_matches_jax_exactly(rng):
    img = _masks(rng)
    expected = np.asarray(j_edt(jnp.asarray(img)))
    got = t_edt(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, expected)
    assert np.all(got[1] == np.float32(np.hypot(32, 32)))


def test_edt_blocked_columns_match_jax(rng):
    # 128 columns run as two 64-column blocks
    img = (rng.random((2, 20, 128)) > 0.1).astype(np.float32)
    np.testing.assert_array_equal(t_edt(torch.from_numpy(img)).numpy(),
                                  np.asarray(j_edt(jnp.asarray(img))))


@pytest.mark.parametrize("out_hw", [(8, 8), (13, 21)])
def test_bilinear_matches_jax(rng, out_hw):
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    expected = jresize.interpolate_bilinear(jnp.asarray(x), *out_hw)
    got = tresize.interpolate_bilinear(_cf(x), *out_hw)
    np.testing.assert_allclose(_cl(got), np.asarray(expected), rtol=1e-6, atol=1e-7)


def test_trilinear_and_nearest_match_jax(rng):
    x = rng.standard_normal((2, 5, 8, 8, 3)).astype(np.float32)
    expected = jresize.interpolate_trilinear(jnp.asarray(x), 3, 12, 6)
    got = tresize.interpolate_trilinear(_cf(x), 3, 12, 6)
    np.testing.assert_allclose(_cl(got), np.asarray(expected), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(_cl(tresize.upsample_nearest_hw(_cf(x))),
                                  np.asarray(jresize.upsample_nearest_hw(jnp.asarray(x))))


def test_normalizer_and_max_pool_match_jax(rng):
    x = rng.standard_normal((2, 9, 9, 3)).astype(np.float32)
    factors = [2.1e-2, 1.6e-2, 7.9e-3]
    jn, tn = JMaxNormalizer(factors), TMaxNormalizer(factors)
    np.testing.assert_allclose(_cl(tn.normalize(_cf(x))), np.asarray(jn.normalize(jnp.asarray(x))),
                               rtol=1e-6)
    np.testing.assert_allclose(_cl(tn.inverse(_cf(x))), np.asarray(jn.inverse(jnp.asarray(x))),
                               rtol=1e-6)
    np.testing.assert_array_equal(_cl(tbasic.max_pool_2x2(_cf(x))),
                                  np.asarray(jbasic.max_pool_2x2(jnp.asarray(x))))


def test_wrappers_route_cpu_to_plain_without_counting(rng):
    k1_before, k2_before = k1.LAUNCHES, k2.LAUNCHES
    x, w, b = _gn_inputs(rng, 32, (4, 4))
    tx, tw, tb = _cf(x), torch.from_numpy(w), torch.from_numpy(b)
    torch.testing.assert_close(k1.groupnorm_act(tx, tw, tb, 32, "silu"),
                               k1.groupnorm_act_plain(tx, tw, tb, 32, "silu"), rtol=0, atol=0)
    targs = [torch.from_numpy(a) for a in _attn_inputs(rng, 8, 32)]
    torch.testing.assert_close(k2.fused_attention(*targs, num_heads=2),
                               t_mha(*targs, num_heads=2), rtol=0, atol=0)
    assert (k1.LAUNCHES, k2.LAUNCHES) == (k1_before, k2_before) == (0, 0)


def test_wrappers_raise_off_cpu_instead_of_falling_back():
    # a non-CPU tensor never takes the plain version: launch or raise
    x = torch.empty((2, 64, 4, 4), device="meta")
    w = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="device"):
        k1.groupnorm_act(x, w, w, 32, "silu")
    xa = torch.empty((2, 8, 32), device="meta")
    wq, bq = torch.empty((32, 96), device="meta"), torch.empty(96, device="meta")
    wo, bo = torch.empty((32, 32), device="meta"), torch.empty(32, device="meta")
    with pytest.raises(ValueError, match="device"):
        k2.fused_attention(xa, wq, bq, wo, bo, 2)
    assert (k1.LAUNCHES, k2.LAUNCHES) == (0, 0)

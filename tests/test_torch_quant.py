"""The port's int8 quantization (``ops/quant.py``), K4's plain version
(``ops/cuda/int8_conv.py``) and the int8 routing of ``Conv2d`` / ``Conv3d``
against the JAX package's ``ops/quant.py`` and ``Conv`` under its
``int8_convs()``, on the CPU.

Inputs come from numpy with a seed and go through both packages, JAX's
channels-last and the port's channels-first. The int8 codes and float32
scales are equal, and so are the int8 convs' outputs, element for element
(the int32 sums are exact on both sides, and the rescale and the cast are
the same IEEE operations), at every shape the int8 path meets: 2D 3x3 and
1x1, Cin 17, 3D 3x3x3, the VAE's stride (1, 2, 2) downsampling with its
asymmetric padding, 3D 1x1x1, reflect padding, float32 and bf16. The
port's direct 3D conv equals JAX's depth-decomposed one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from diffusion_model_project_tpu.models import layers as jlayers
from diffusion_model_project_tpu.ops import quant as jquant

from diffusion_model_project_tpu_torch.models import layers
from diffusion_model_project_tpu_torch.ops import quant
from diffusion_model_project_tpu_torch.ops.cuda import int8_conv as k4
from diffusion_model_project_tpu_torch.utils import weights

from test_torch_train_step import one_torch_thread  # noqa: F401

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _cl(t: torch.Tensor) -> np.ndarray:
    """A channels-first port tensor as a channels-last float32 array."""
    return np.moveaxis(t.float().numpy(), 1, -1)


def _jnp(a: np.ndarray, jdt):
    return jnp.asarray(a).astype(jdt)


def _x(rng, shape, dtype):
    """Channels-first activations with per-channel spread, in ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    x *= rng.uniform(0.2, 3.0, (1, shape[1]) + (1,) * (len(shape) - 2)).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def _w(rng, cout, cin, kernel):
    return torch.from_numpy(rng.standard_normal((cout, cin) + kernel).astype(np.float32) * 0.1)


def test_quantizers_equal_jax():
    rng = np.random.default_rng(0)
    for name, (tdt, jdt) in DTYPES.items():
        x = _x(rng, (2, 24, 3, 5, 6), tdt)
        xj = _jnp(_cl(x), jdt)
        q, s = quant.quantize_act(x)
        jq, js = jquant.quantize_act(xj)
        np.testing.assert_array_equal(_cl(q), np.asarray(jq, np.float32))
        assert s.item() == float(js) and s.dtype == torch.float32
        q, s = quant.quantize_act_per_channel(x)
        jq, js = jquant.quantize_act_per_channel(xj)
        np.testing.assert_array_equal(_cl(q), np.asarray(jq, np.float32))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        # the channels-last writer K4 reads, in chunks of one sample
        saved = quant.QUANT_CHUNK
        try:
            quant.QUANT_CHUNK = x[0].numel()
            q_cl, s_cl = quant.quantize_channels_last(x, 32)
        finally:
            quant.QUANT_CHUNK = saved
        assert q_cl.shape == (2, 3, 5, 6, 32) and not q_cl[..., 24:].any()
        np.testing.assert_array_equal(q_cl[..., :24].float().numpy(), np.asarray(jq, np.float32))
        assert torch.equal(s_cl, s)
    w = _w(rng, 40, 24, (3, 3, 3))
    q, s = quant.quantize_weight(w)
    jq, js = jquant.quantize_weight(jnp.asarray(w.permute(2, 3, 4, 1, 0).numpy()))
    np.testing.assert_array_equal(q.permute(2, 3, 4, 1, 0).numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert quant.use_float_path(15, 32) and quant.use_float_path(16, 31)
    assert not quant.use_float_path(16, 32)
    assert (quant.MIN_IN_CH, quant.MIN_OUT_CH) == (jquant.MIN_IN_CH, jquant.MIN_OUT_CH)


# (x shape channels-first, Cout, kernel, stride, padding (lo, hi) per dim)
CASES = {
    "2d 3x3": ((2, 32, 8, 8), 32, (3, 3), (1, 1), ((1, 1), (1, 1))),
    "2d 1x1": ((2, 32, 8, 8), 32, (1, 1), (1, 1), ((0, 0), (0, 0))),
    "2d Cin 17": ((2, 17, 8, 8), 32, (3, 3), (1, 1), ((1, 1), (1, 1))),
    "3d 3x3x3": ((2, 32, 3, 8, 8), 32, (3, 3, 3), (1, 1, 1), ((1, 1), (1, 1), (1, 1))),
    "3d stride (1,2,2), asymmetric pad": ((2, 32, 3, 8, 8), 32, (3, 3, 3), (1, 2, 2),
                                          ((1, 1), (0, 1), (0, 1))),
    "3d 1x1x1": ((2, 32, 3, 8, 8), 64, (1, 1, 1), (1, 1, 1), ((0, 0), (0, 0), (0, 0))),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_int8_conv_equals_jax(case, dtype):
    shape, cout, kernel, stride, pads = CASES[case]
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(sorted(CASES).index(case))
    x = _x(rng, shape, tdt)
    w = _w(rng, cout, shape[1], kernel)
    got = quant.int8_conv(x, w, stride, pads, tdt)
    assert got.dtype == tdt
    ndim = len(kernel)
    spec = (("NHWC", "HWIO", "NHWC"), ("NDHWC", "DHWIO", "NDHWC"))[ndim - 2]
    wj = jnp.asarray(np.moveaxis(np.moveaxis(w.numpy(), 0, -1), 0, -2))  # (*k, in, out)
    xj = _jnp(_cl(x), jdt)
    dn = lax.conv_dimension_numbers(xj.shape, wj.shape, spec)
    want = jquant.int8_conv(xj, wj, stride, list(pads), dn, jdt)
    np.testing.assert_array_equal(_cl(got), np.asarray(want, np.float32))


def test_direct_conv3d_equals_jax_decomposed():
    """JAX's depth-decomposed int8 conv (three depth taps over the depth-padded
    tensor, one quantization) gives the port's direct conv's int32 sums:
    depth zero-padding changes no amax."""
    rng = np.random.default_rng(7)
    x = _x(rng, (2, 32, 5, 6, 6), torch.float32)
    w = _w(rng, 32, 32, (3, 3, 3))
    got = quant.int8_conv(x, w, (1, 1, 1), ((1, 1), (1, 1), (1, 1)), torch.float32)
    xp = np.pad(_cl(x), ((0, 0), (1, 1), (0, 0), (0, 0), (0, 0)))
    want = jquant.int8_conv3d_decomposed(
        jnp.asarray(xp), jnp.asarray(w.permute(2, 3, 4, 1, 0).numpy()), (1, 1),
        [(1, 1), (1, 1)], jnp.float32)
    np.testing.assert_array_equal(_cl(got), np.asarray(want))


def test_plain_version_is_exact_where_float32_sums_are_not():
    """Sums past 2^24 (27 taps x 512 channels of +/-127 codes): the float64
    plain version holds them exactly, as the kernel's int32 does."""
    x_q = torch.full((1, 3, 3, 3, 512), 127, dtype=torch.int8)
    w_q = torch.full((32, 3, 3, 3, 512), 127, dtype=torch.int8)
    w_q[:, 0, 0, 0, 0] = 126
    sw = torch.ones(32)
    acc = 27 * 512 * 127 * 127 - 127  # 222,973,346 > 2^24
    y = k4.int8_conv(x_q, w_q, sw, [1, 1, 1], [0] * 6, torch.float32)
    assert y.shape == (1, 32, 1, 1, 1) and y.dtype == torch.float32
    assert torch.equal(y, torch.full_like(y, float(np.float32(acc))))
    assert k4.output_shape((2, 11, 256, 256, 128), (128, 3, 3, 3, 128), (1, 2, 2),
                           (1, 1, 0, 1, 0, 1)) == (2, 128, 11, 128, 128)
    assert k4.padded_channels(17) == 32 and k4.padded_channels(128) == 128


def test_wrapper_refusals():
    x_q = torch.zeros((1, 1, 4, 4, 32), dtype=torch.int8)
    w_q = torch.zeros((32, 1, 3, 3, 32), dtype=torch.int8)
    sw = torch.ones(32)
    call = lambda *a, **kw: k4.int8_conv(*a, **kw)  # noqa: E731
    with pytest.raises(TypeError, match="int8"):
        call(x_q.float(), w_q, sw, [1, 1, 1], [0, 0, 1, 1, 1, 1], torch.float32)
    with pytest.raises(TypeError, match="out_dtype"):
        call(x_q, w_q, sw, [1, 1, 1], [0, 0, 1, 1, 1, 1], torch.float16)
    with pytest.raises(ValueError, match="multiple of 16"):
        call(x_q[..., :24], w_q[..., :24], sw, [1, 1, 1], [0, 0, 1, 1, 1, 1], torch.float32)
    with pytest.raises(ValueError, match="Cp"):
        call(x_q, w_q[..., :16], sw, [1, 1, 1], [0, 0, 1, 1, 1, 1], torch.float32)
    with pytest.raises(ValueError, match="sw"):
        call(x_q, w_q, sw[:16], [1, 1, 1], [0, 0, 1, 1, 1, 1], torch.float32)
    with pytest.raises(ValueError, match="empty output"):
        call(x_q[:, :, :2, :2], w_q, sw, [1, 1, 1], [0] * 6, torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        call(x_q, w_q, sw.requires_grad_(), [1, 1, 1], [0, 0, 1, 1, 1, 1], torch.float32)


def _port_conv(rng, cls, cin, cout, k, **kw):
    conv = cls(cin, cout, k, **kw)
    with torch.no_grad():
        conv.weight.copy_(_w(rng, cout, cin, tuple(conv.kernel_size)))
        if conv.bias is not None:
            conv.bias.copy_(torch.from_numpy(rng.standard_normal(cout).astype(np.float32)))
    return conv.requires_grad_(False)


# (port class, Cin, Cout, kernel, port kwargs, JAX Conv kwargs, x spatial)
MODULES = {
    "UNet Block conv, reflect": (
        layers.Conv2d, 17, 32, 3, dict(padding=1, padding_mode="reflect", bias=False),
        dict(padding=1, padding_mode="reflect", use_bias=False), (8, 8)),
    "VAE conv, bias": (layers.Conv3d, 32, 32, 3, dict(padding=1), dict(padding=1), (3, 8, 8)),
    "VAE down1": (layers.Conv3d, 32, 32, 3,
                  dict(stride=(1, 2, 2), extra_pad=((1, 1), (0, 1), (0, 1))),
                  dict(strides=(1, 2, 2), extra_pad=((1, 1), (0, 1), (0, 1))), (3, 8, 8)),
    "VAE residual_layer": (layers.Conv3d, 32, 64, 1, {}, {}, (3, 8, 8)),
    "thin stem 3->32 (float)": (layers.Conv3d, 3, 32, 3, dict(padding=1), dict(padding=1),
                                (3, 8, 8)),
    "thin head 32->8 (float)": (layers.Conv2d, 32, 8, 3, dict(padding=1), dict(padding=1),
                                (8, 8)),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(MODULES))
def test_conv_modules_under_int8_convs_equal_jax(name, dtype, monkeypatch):
    # JAX's direct 3D conv (its depth decomposition gives the same int32 sums,
    # test_direct_conv3d_equals_jax_decomposed) at the shapes above, whose
    # compiled ops it reuses
    monkeypatch.setattr(jlayers, "CONV3D_DECOMPOSE", False)
    cls, cin, cout, k, port_kw, jax_kw, spatial = MODULES[name]
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(sorted(MODULES).index(name) + 20)
    conv = _port_conv(rng, cls, cin, cout, k, **port_kw)
    x = _x(rng, (2, cin) + spatial, tdt)
    with torch.no_grad():
        with layers.int8_convs():
            assert layers.in_int8_convs()
            got = conv(x)
        assert not layers.in_int8_convs()
        float_out = conv(x)
    params = weights._conv_to_flax({f"c.{k}": v for k, v in conv.state_dict().items()}, "c")
    params = {key: jnp.asarray(v.numpy()) for key, v in params.items()}
    jconv = jlayers.Conv(features=cout, kernel_size=k, **jax_kw)
    with jlayers.int8_convs():
        want = jconv.apply({"params": params}, _jnp(_cl(x), jdt))
    assert got.dtype == tdt
    assert layers.routes_int8(conv) is False  # outside the context
    if quant.use_float_path(cin, cout):
        # the thin-channel convs stay on the float path, bit for bit; JAX's
        # float conv sums in another order (bf16: one rounding of the output)
        assert torch.equal(got, float_out)
        tol = 1e-5 if tdt == torch.float32 else 2.0 ** -7
        scale = float(np.abs(np.asarray(want, np.float32)).max())
        assert np.abs(_cl(got) - np.asarray(want, np.float32)).max() <= tol * scale
    else:
        np.testing.assert_array_equal(_cl(got), np.asarray(want, np.float32))
        assert not torch.equal(got, float_out)


def test_int8_flag_is_per_thread():
    import threading

    seen = {}

    def other():
        seen["other"] = layers.in_int8_convs()

    with layers.int8_convs():
        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=30)
        seen["this"] = layers.in_int8_convs()
    assert not th.is_alive()
    assert seen == {"this": True, "other": False}

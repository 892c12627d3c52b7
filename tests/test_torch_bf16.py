"""The port's bfloat16 path against the JAX package's bfloat16 path, on the CPU.

The tiny predictor of ``tests/test_torch_predictor.py`` runs DDIM-5 from the
same noise four times: each package in float32 and with ``compute_dtype``
bfloat16. The port's bf16 output must lie within twice the JAX package's own
bf16-vs-f32 spread of the JAX bf16 output (both relative to the largest
magnitude), which adds a check on the bf16 path and loosens none; and the
port's own bf16-vs-f32 spread must show that bf16 ran at all.

Where the two bf16 paths round differently (the sums in float32 or wider on
both sides):
  - conv and dense bias: the JAX layers round the product to bf16 and then
    add the bf16 bias with a second rounding (``models/layers.py`` ``Conv``,
    ``Dense``: ``...astype(x.dtype)`` then ``+ bias``); torch's CPU
    convolution and ``F.linear`` add the bias before their one rounding;
  - the order of the float32 sums inside each bf16 convolution and matmul
    (XLA's CPU kernels against oneDNN's), which moves the rounding to bf16
    across a boundary now and then;
  - elementwise chains in bf16 (the time embedding's sin/cos and MLP, SiLU
    after GroupNorm, the residual adds): each torch op computes in float32
    and rounds its own result, where XLA may fuse a chain and round once.
GroupNorm statistics, the scheduler, normalization and the attention
softmax are float32 in both.
"""
import jax
import numpy as np
import torch

from test_torch_predictor import HW, LATENT, S, _port_predictor
from test_torch_predictor import jax_predictor  # noqa: F401  (module fixture)
from test_torch_train_step import one_torch_thread  # noqa: F401

STEPS = 5


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_port_bf16_within_twice_jax_own_bf16_spread(jax_predictor):
    rng = np.random.default_rng(12)
    b = 2
    img = (rng.random((b, S, 1, HW, HW)) > 0.3).astype(np.float32)
    vel = (rng.standard_normal((b, S, 3, HW, HW)) * 1e-2).astype(np.float32)
    vel[:, :, 2] = 0.0
    noise = rng.standard_normal((b * S, LATENT, HW // 4, HW // 4)).astype(np.float32)

    def jax_run(pred):
        return np.asarray(jax.jit(lambda p: p.predict_ddim(img, vel, num_steps=STEPS,
                                                           noise=noise))(pred))

    def port_run(dtype):
        pred = _port_predictor(jax_predictor)
        pred.compute_dtype = dtype
        return pred.predict_ddim(torch.from_numpy(img), torch.from_numpy(vel),
                                 num_steps=STEPS, noise=torch.from_numpy(noise)).numpy()

    j32, j16 = jax_run(jax_predictor), jax_run(jax_predictor.with_compute_dtype("bfloat16"))
    p32, p16 = port_run(torch.float32), port_run(torch.bfloat16)
    jax_spread = _rel(j16, j32)
    assert 1e-3 < jax_spread < 1e-1          # bf16 really ran, and sanely
    assert _rel(p32, j32) <= 1e-4            # the float32 paths agree
    assert np.isfinite(p16).all()
    assert _rel(p16, p32) > 1e-3             # bf16 really ran in the port
    assert _rel(p16, j16) <= 2 * jax_spread, (_rel(p16, j16), jax_spread)

"""The save side of the port's checkpoints, on the CPU, against the JAX package:

- ``utils/flax_msgpack.py::msgpack_serialize`` writes the bytes
  ``flax.serialization.msgpack_serialize`` writes, bit for bit (bfloat16,
  numpy scalars, nested lists, chunked leaves via a small MAX_CHUNK_SIZE);
- ``utils/weights.py``'s inverse transforms give the JAX importer's flax
  trees back from the port's state dicts;
- ``model.msgpack`` and ``train_state.msgpack`` cross-read in both
  directions (JAX's ``load_predictor_state`` / ``load_train_state`` and the
  port's), Adam moments, step count, learning rate and EMA equal, and a
  step after the restore equal to optax's;
- ``utils/async_ckpt.py``: FIFO, atomic, failures raised, snapshots apart
  from the live tensors.
"""
import os

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_model_project_tpu.training import train_diffusion as jtrain
from diffusion_model_project_tpu.utils import checkpoint as jckpt
from diffusion_model_project_tpu.utils import torch_import as ti

from diffusion_model_project_tpu_torch.models.vae import DualBranchVAE
from diffusion_model_project_tpu_torch.training.train_diffusion import ema_params, make_optimizer
from diffusion_model_project_tpu_torch.utils import checkpoint, flax_msgpack, weights
from diffusion_model_project_tpu_torch.utils.async_ckpt import (AsyncCheckpointWriter,
                                                                device_snapshot)

from test_torch_train_step import (NORM_OUTPUT, UNET_KW, jax_twin,  # noqa: F401
                                   one_torch_thread, port_predictor)


def _bf16(a):
    """(ml_dtypes bfloat16 numpy array for flax, torch bfloat16 tensor for the port)."""
    j = np.asarray(jnp.asarray(a, jnp.bfloat16))
    return j, torch.from_numpy(j.view(np.uint16).copy()).view(torch.bfloat16)


def _trees():
    rng = np.random.default_rng(0)
    bf_j, bf_t = _bf16(rng.standard_normal((3, 5)))
    common = {"w": rng.standard_normal((4, 3, 2)).astype(np.float32),
              "i16": np.arange(300, dtype=np.int16), "u8": np.arange(7, dtype=np.uint8),
              "empty": np.zeros((0, 3), np.float32), "zero_d": np.asarray(3, np.int64),
              "scalars": {"i": np.int64(-5), "f": np.float32(2.5), "d": np.float64(0.1),
                          "b": np.bool_(True)},
              "python": [1, -7, -200, 70000, -2 ** 40, 2 ** 63, 1.5, "s" * 40, None, True,
                         b"xy", {"k": 1}],
              "nested": {"z": {}, "a": {"c": np.ones(70, np.float64)}}, "str": "x"}
    return {"plain": (dict(common), dict(common)),
            "bfloat16": ({**common, "bf": bf_j}, {**common, "bf": bf_t}),
            "tensors": (common, {**common, "w": torch.from_numpy(common["w"].copy()),
                                 "i16": torch.from_numpy(common["i16"].copy())})}


@pytest.mark.parametrize("chunk", [None, 64])
@pytest.mark.parametrize("name", ["plain", "bfloat16", "tensors"])
def test_msgpack_serialize_equals_flax_bit_for_bit(name, chunk, monkeypatch):
    if chunk is not None:
        monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", chunk)
    j_tree, t_tree = _trees()[name]
    data = flax_msgpack.msgpack_serialize(t_tree)
    assert data == fser.msgpack_serialize(j_tree)
    if chunk is not None:
        assert b"__msgpack_chunked_array__" in data
    back = flax_msgpack.restore(data)
    np.testing.assert_array_equal(back["i16"], j_tree["i16"])
    if name == "bfloat16":
        assert torch.equal(back["bf"], t_tree["bf"])


def test_msgpack_serialize_refuses_what_flax_cannot_write():
    with pytest.raises(TypeError, match="tuple"):
        flax_msgpack.msgpack_serialize({"t": (1, 2)})
    with pytest.raises(ValueError, match="object"):
        flax_msgpack.msgpack_serialize({"o": np.array([None])})


@pytest.fixture(scope="module")
def pair():
    pred = port_predictor(seed=5)
    return pred, jax_twin(pred)


def _tree_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _assert_trees_equal(a, b):
    fa, fb = (jax.tree_util.tree_flatten_with_path(_tree_np(t))[0] for t in (a, b))
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(x, y, err_msg=jax.tree_util.keystr(path))


def test_inverse_transforms_give_the_jax_importers_trees(pair):
    pred, jpred = pair
    _assert_trees_equal(weights.unet_to_flax(pred.model.state_dict()), jpred.unet_params)
    _assert_trees_equal(weights.dual_vae_to_flax(pred.vae.state_dict()), jpred.vae_params)
    vae = DualBranchVAE(latent_channels=4, features=(32, 32, 32), conditional=True)
    vae.init_parameters_(torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in vae.state_dict().items()}
    _assert_trees_equal(weights.dual_vae_to_flax(vae.state_dict()), ti.import_dual_vae(sd))


def test_model_msgpack_cross_reads(pair, tmp_path):
    pred, jpred = pair
    port_file = str(tmp_path / "port_model.msgpack")
    checkpoint.save_predictor(pred, port_file)
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    restored = jckpt.load_predictor_state(jax_twin(port_predictor(seed=9)), port_file)
    _assert_trees_equal(restored.unet_params, jpred.unet_params)
    _assert_trees_equal(restored.vae_params, jpred.vae_params)
    np.testing.assert_array_equal(np.asarray(restored.norm_output.scale_factors),
                                  np.asarray(NORM_OUTPUT, np.float32))

    jax_file = str(tmp_path / "jax_model.msgpack")
    jckpt.save_predictor(jpred, jax_file)
    other = checkpoint.load_predictor_state(port_predictor(seed=9), jax_file)
    for (k, a), b in zip(other.state_dict().items(), pred.state_dict().values()):
        assert torch.equal(a, b), k
    # a frozen VAE copy spliced in writes the same bytes
    spliced = str(tmp_path / "spliced.msgpack")
    checkpoint.save_predictor(pred, spliced, frozen_vae=checkpoint.frozen_vae_params(pred))
    assert open(spliced, "rb").read() == open(port_file, "rb").read()


def _random_grads(model, rng):
    return {n: rng.standard_normal(p.shape).astype(np.float32)
            for n, p in model.named_parameters()}


def _jax_steps(jopt, state, params, grads_list):
    @jax.jit
    def step(grads, state, params):
        updates, state = jopt.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    for g in grads_list:
        params, state = step(ti.import_unet(g, num_levels=2), state, params)
    return params, state


def _port_steps(opt, model, grads_list):
    for g in grads_list:
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(g[n])
        opt.step()


def _check_opt_state(opt, state_j, weight_decay):
    adam_j = state_j.inner_state[1 if weight_decay > 0 else 0]
    assert opt.count == int(adam_j.count) == int(state_j.count)
    np.testing.assert_allclose(opt.learning_rate, float(state_j.hyperparams["learning_rate"]),
                               rtol=1e-7)
    for key, tree in (("exp_avg", adam_j.mu), ("exp_avg_sq", adam_j.nu)):
        expected = weights.export_unet(_tree_np(tree))
        got = opt._moment(key)
        for k in expected:
            np.testing.assert_array_equal(got[k].numpy(), expected[k], err_msg=f"{key} {k}")
    ema_j = jtrain.ema_params(state_j)
    if ema_j is not None:
        expected = weights.export_unet(_tree_np(ema_j))
        for k, v in ema_params(opt).items():
            np.testing.assert_array_equal(v.numpy(), expected[k], err_msg=k)


@pytest.mark.parametrize("weight_decay,ema_decay", [(0.0, 0.0), (1e-2, 0.9)])
def test_train_state_written_by_jax_restores_in_the_port(pair, tmp_path, weight_decay,
                                                         ema_decay):
    pred, jpred = pair
    rng = np.random.default_rng(1)
    grads = [_random_grads(pred.model, rng) for _ in range(3)]
    jopt = jtrain.make_optimizer(1e-3, weight_decay, ema_decay=ema_decay)
    params_j, state_j = _jax_steps(jopt, jopt.init(jpred.unet_params), jpred.unet_params,
                                   grads[:2])
    import dataclasses

    path = str(tmp_path / "train_state.msgpack")
    jckpt.save_train_state(path, dataclasses.replace(jpred, unet_params=params_j), state_j,
                           epoch=3, best_loss=0.25)
    port = port_predictor(seed=9)
    opt = make_optimizer(port.model, 5e-2, weight_decay, ema_decay)
    port, opt, start, best = checkpoint.load_train_state(path, port, opt)
    assert (start, best) == (4, 0.25) and checkpoint.peek_train_state_epoch(path) == 4
    _check_opt_state(opt, state_j, weight_decay)
    # resuming: one more step on each side from the restored state
    params_j, state_j = _jax_steps(jopt, state_j, params_j, grads[2:])
    _port_steps(opt, port.model, grads[2:])
    expected = weights.export_unet(_tree_np(params_j))
    scale = max(np.abs(v).max() for v in expected.values())
    worst = max(np.abs(p.detach().numpy() - expected[n]).max()
                for n, p in port.model.named_parameters())
    assert worst <= 1e-5 * scale


@pytest.mark.parametrize("weight_decay,ema_decay", [(0.0, 0.0), (1e-2, 0.9)])
def test_train_state_written_by_the_port_restores_in_jax(pair, tmp_path, weight_decay,
                                                         ema_decay):
    pred, jpred = pair
    port = port_predictor(seed=5)
    opt = make_optimizer(port.model, 2e-3, weight_decay, ema_decay)
    _port_steps(opt, port.model, [_random_grads(port.model, np.random.default_rng(2))
                                  for _ in range(2)])
    path = str(tmp_path / "train_state.msgpack")
    checkpoint.save_train_state(path, port, opt, epoch=1, best_loss=float("inf"))
    jopt = jtrain.make_optimizer(1e-3, weight_decay, ema_decay=ema_decay)
    restored, state_j, start, best = jckpt.load_train_state(
        path, jax_twin(port_predictor(seed=9)), jopt.init(jpred.unet_params))
    assert (start, best) == (2, float("inf"))
    _check_opt_state(opt, state_j, weight_decay)
    _assert_trees_equal(restored.unet_params, weights.unet_to_flax(port.model.state_dict()))


def test_train_state_of_other_optimizer_flags_raises(tmp_path):
    port = port_predictor(seed=5)
    opt = make_optimizer(port.model, 1e-3, 0.0, ema_decay=0.9)
    path = str(tmp_path / "train_state.msgpack")
    checkpoint.save_train_state(path, port, opt, epoch=0, best_loss=1.0)
    for wd, ema in ((0.0, 0.0), (1e-2, 0.9)):
        with pytest.raises(ValueError, match="--ema-decay on/off must match"):
            checkpoint.load_train_state(path, port, make_optimizer(port.model, 1e-3, wd, ema))
    wrong = port_predictor(seed=5, unet_kw=dict(UNET_KW, features=(8, 24)))
    with pytest.raises(ValueError, match="unet_params"):
        checkpoint.load_train_state(path, wrong, make_optimizer(wrong.model, 1e-3, 0.0, 0.9))


# ------------------------------------------------------------ async writer


def test_async_writer_is_fifo_atomic_and_raises_failures(tmp_path):
    order = []

    def slow(tree):
        order.append(tree["i"])
        return str(tree["i"]).encode()

    with AsyncCheckpointWriter(serialize=slow) as writer:
        for i in range(5):
            writer.submit(str(tmp_path / "f"), {"i": i})
        writer.join()
    assert order == list(range(5)) and (tmp_path / "f").read_bytes() == b"4"
    assert os.listdir(tmp_path) == ["f"]

    writer = AsyncCheckpointWriter()
    writer.submit(str(tmp_path / "missing" / "x"), {"a": np.zeros(2)})
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        writer.close()
    writer.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        writer.submit(str(tmp_path / "g"), {})


def test_device_snapshot_is_apart_from_the_live_tensors():
    live = torch.arange(6.0).reshape(2, 3)
    tree = {"w": live.t(), "n": np.ones(2), "l": [live], "k": 3}
    snap = device_snapshot(tree)
    live.add_(100.0)  # an optimizer step updates in place
    assert torch.equal(snap["w"], torch.arange(6.0).reshape(2, 3).t())
    assert torch.equal(snap["l"][0], torch.arange(6.0).reshape(2, 3))
    assert snap["n"] is tree["n"] and snap["k"] == 3
    assert flax_msgpack.msgpack_serialize(snap) == fser.msgpack_serialize(
        {"w": np.arange(6.0, dtype=np.float32).reshape(2, 3).T, "n": np.ones(2),
         "l": [np.arange(6.0, dtype=np.float32).reshape(2, 3)], "k": 3})

"""The port's noise-prediction step (``encode_target``, ``forward``), its eval
step and its ``evaluate`` CLI, on the CPU.

``encode_target`` and ``forward`` run against the JAX package's on the tiny
predictor of ``tests/test_torch_predictor.py`` with explicit noise and
timesteps, each within 1e-4 of max|JAX| (JAX returns eps_pred and noise
channels-last; they are transposed once here). The eval step equals JAX's
``forward`` + cost on the same noise and t. ``evaluate`` runs on a tiny run
dir written from the port's own predictor: ``test_result.txt`` holds the
mean of the eval step's loss over the test batches, drawn from one
generator in batch order, and a run dir without time-embedding weights
loads through the legacy retry.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_project_tpu.losses.metrics import cost_function as j_cost

from diffusion_model_project_tpu_torch import evaluate
from diffusion_model_project_tpu_torch.data import get_loader
from diffusion_model_project_tpu_torch.diffusion.predictor import LatentDiffusionPredictor
from diffusion_model_project_tpu_torch.training.helper import get_norm_params
from diffusion_model_project_tpu_torch.training.steps import make_diffusion_eval_step

from test_torch_data import write_dataset
from test_torch_predictor import (HW, LATENT, NORM_OUTPUT, S, T, UNET_KW, VAE_FEATURES,
                                  _port_predictor, jax_predictor)  # noqa: F401 (fixture)
from test_torch_train_step import one_torch_thread  # noqa: F401

COST = "normalized_mse_loss_per_component"
# one compile each (the JAX predictor is a pytree)
_j_encode = jax.jit(lambda p, v: p.encode_target(v))
_j_forward = jax.jit(lambda p, img, v2d, x0, noise, t: p.forward(img, v2d, x0, noise=noise, t=t))


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    img = (rng.random((b, S, 1, HW, HW)) > 0.3).astype(np.float32)
    v2d = (rng.standard_normal((b, S, 3, HW, HW)) * 1e-2).astype(np.float32)
    v2d[:, :, 2] = 0.0
    v3d = (rng.standard_normal((b, S, 3, HW, HW)) * 1e-2).astype(np.float32)
    noise = rng.standard_normal((b, S, LATENT, HW // 4, HW // 4)).astype(np.float32)
    t = rng.integers(0, T, (b * S,)).astype(np.int32)
    return img, v2d, v3d, noise, t


def _close(got, expected):
    scale = np.abs(expected).max()
    assert got.shape == expected.shape and scale > 0
    assert np.abs(got - expected).max() <= 1e-4 * scale


def _cl_to_cf(x):
    return np.moveaxis(np.asarray(x), -1, -3)


@pytest.fixture(scope="module")
def port(jax_predictor):
    return _port_predictor(jax_predictor)


def test_encode_target_and_forward_match_jax(jax_predictor, port):
    img, v2d, v3d, noise, t = _batch(1)
    x_start_j = _j_encode(jax_predictor, v3d)
    x_start = port.encode_target(torch.from_numpy(v3d))
    assert x_start.dtype == torch.float32 and tuple(x_start.shape) == (2, S, LATENT, 8, 8)
    _close(x_start.numpy(), np.asarray(x_start_j))

    eps_j, noise_j, t_j, x_t_j = _j_forward(jax_predictor, img, v2d, x_start_j, noise, t)
    with torch.no_grad():
        eps, noise_p, t_p, x_t = port.forward(
            torch.from_numpy(img), torch.from_numpy(v2d), torch.from_numpy(np.array(x_start_j)),
            noise=torch.from_numpy(noise), t=torch.from_numpy(t))
    assert tuple(eps.shape) == (2 * S, LATENT, 8, 8)
    np.testing.assert_array_equal(noise_p.numpy(), _cl_to_cf(noise_j))
    np.testing.assert_array_equal(t_p.numpy(), np.asarray(t_j))
    _close(x_t.numpy(), _cl_to_cf(x_t_j))
    _close(eps.numpy(), _cl_to_cf(eps_j))


def test_forward_draws_from_the_generator(port):
    img, v2d, v3d, _, _ = _batch(2)
    img, v2d = torch.from_numpy(img), torch.from_numpy(v2d)
    x_start = port.encode_target(torch.from_numpy(v3d))
    with torch.no_grad():
        _, noise, t, _ = port.forward(img, v2d, x_start, generator=torch.Generator().manual_seed(3))
        gen = torch.Generator().manual_seed(3)
        expected_noise = torch.randn((2 * S, LATENT, 8, 8), generator=gen)
        expected_t = torch.randint(0, T, (2 * S,), generator=gen)
        torch.testing.assert_close(noise, expected_noise, rtol=0, atol=0)
        assert torch.equal(t, expected_t) and t.shape == (2 * S,)
        assert 0 <= int(t.min()) and int(t.max()) < T and len(set(t.tolist())) > 1
        # a given t keeps the generator for the noise alone, and the reverse
        _, noise2, t2, _ = port.forward(img, v2d, x_start, t=expected_t,
                                        generator=torch.Generator().manual_seed(3))
        torch.testing.assert_close(noise2, expected_noise, rtol=0, atol=0)
        assert torch.equal(t2, expected_t)
        with pytest.raises(ValueError, match="needs a generator"):
            port.forward(img, v2d, x_start, noise=expected_noise)
        with pytest.raises(ValueError, match="needs a generator"):
            port.forward(img, v2d, x_start, t=expected_t)


def test_forward_keeps_autograd(port):
    img, v2d, v3d, noise, t = _batch(4, b=1)
    x_start = port.encode_target(torch.from_numpy(v3d))
    w = port.model.final_conv.weight
    w.requires_grad_(True)
    try:
        eps, noise_t, _, _ = port.forward(torch.from_numpy(img), torch.from_numpy(v2d), x_start,
                                          noise=torch.from_numpy(noise), t=torch.from_numpy(t))
        torch.mean(torch.square(eps - noise_t)).backward()
        assert w.grad is not None and torch.isfinite(w.grad).all() and w.grad.abs().max() > 0
    finally:
        w.requires_grad_(False)
        w.grad = None


def test_eval_step_matches_jax_forward_and_cost(jax_predictor, port):
    img, v2d, v3d, noise, t = _batch(5)
    eps_j, noise_j, _, _ = _j_forward(jax_predictor, img, v2d, _j_encode(jax_predictor, v3d),
                                      noise, t)
    expected = float(j_cost(COST)(jnp.moveaxis(eps_j, -1, -3), jnp.moveaxis(noise_j, -1, -3)))
    step = make_diffusion_eval_step(cost_name=COST)
    got = step(port, {"img": img, "U_2d": v2d, "U": v3d}, noise=torch.from_numpy(noise),
               t=torch.from_numpy(t))["val_loss"]
    assert got.ndim == 0
    np.testing.assert_allclose(got.item(), expected, rtol=1e-4)


# ----------------------------------------------------------------- the CLI


def _write_run_dir(root, pred, data, name, model_kwargs):
    run = root / name
    run.mkdir()
    torch.save({k: v for k, v in pred.state_dict().items()
                if k.startswith(("model.", "normalizer."))}, run / "best_model.pt")
    predictor = {"model_name": "UNet", "model_kwargs": model_kwargs, "distance_transform": True,
                 "num_timesteps": T, "vae_path": str(root / "vae")}
    (run / "log.json").write_text(json.dumps({"params": {
        "dataset": {"root_dir": str(data), "batch_size": 2, "use_3d": True},
        "training": {"predictor_type": "latent-diffusion", "predictor": predictor,
                     "cost_function": COST}}}))
    return run


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """A run dir, a legacy one (a UNet without time embeddings, logged with
    them), their VAE dir and a dataset whose test split holds 3 samples."""
    root = tmp_path_factory.mktemp("evaluate")
    dirs = {}
    for name, tdim in (("run", 64), ("legacy", None)):
        pred = LatentDiffusionPredictor.create(
            {**UNET_KW, "time_embedding_dim": tdim}, seed=4, device="cpu", num_timesteps=T,
            latent_channels=LATENT, vae_features=VAE_FEATURES)
        torch.nn.init.normal_(pred.model.final_conv.weight, std=0.05,
                              generator=torch.Generator().manual_seed(5))
        pred.set_normalizer({"input": [1.0], "output": NORM_OUTPUT})
        if name == "run":
            (root / "vae").mkdir()
            torch.save(pred.vae.state_dict(), root / "vae" / "vae.pt")
            (root / "vae" / "vae_log.json").write_text(json.dumps({"norm_factors": NORM_OUTPUT}))
            data = write_dataset(root / "data", n=12, with_y=False, seed=6, hw=HW)
        dirs[name] = _write_run_dir(root, pred, data, name, dict(UNET_KW))
    return dirs


def _expected_losses(run, seed):
    """The eval step over the test batches in order, one generator."""
    pred = evaluate.load_predictor(str(run), device="cpu", use_ema=False)
    params = json.loads((run / "log.json").read_text())["params"]
    (_, _, test), = get_loader(params["dataset"]["root_dir"], batch_size=2, use_3d=True,
                               seed=seed)
    step = make_diffusion_eval_step(cost_name=COST)
    gen = torch.Generator().manual_seed(seed)
    return [step(pred, {"img": d["microstructure"], "U_2d": d["velocity_input"],
                        "U": d["velocity"]}, gen)["val_loss"].item() for d in test]


def test_evaluate_writes_the_mean_test_loss(run_dirs, capsys):
    run = run_dirs["run"]
    res = evaluate.run(["--model-dir", str(run), "--device", "cpu", "--seed", "11"])
    expected = _expected_losses(run, 11)
    assert len(expected) == 2  # 3 test samples at batch 2
    assert res.losses == expected and len(res.batch_seconds) == 2
    assert np.isfinite(res.test_loss) and res.test_loss == float(np.mean(expected))
    lines = (run / "test_result.txt").read_text().splitlines()
    assert lines == [f"cost_function: {COST}", f"test_loss: {float(np.mean(expected))}",
                     "num_batches: 2"]
    evaluate.main(["--model-dir", str(run), "--device", "cpu", "--seed", "11"])
    assert f"Test loss ({COST}): {res.test_loss}" in capsys.readouterr().out
    # statistics.json as get_loader wrote it: U_per_component first
    norm = get_norm_params(str(json.loads((run / "log.json").read_text())["params"]["dataset"]
                               ["root_dir"]) + "/statistics.json")
    assert norm["input"] is None and len(norm["output"]) == 3


def test_evaluate_retries_a_legacy_run_dir(run_dirs, capsys):
    run = run_dirs["legacy"]
    with pytest.raises(ValueError, match="time_mlp"):
        from diffusion_model_project_tpu_torch.utils.checkpoint import predictor_from_directory

        predictor_from_directory(str(run), device="cpu")
    res = evaluate.run(["--model-dir", str(run), "--device", "cpu", "--batch-size", "3"])
    assert "Retrying with time_embedding_dim=None" in capsys.readouterr().out
    assert res.predictor.model.time_embedding_dim is None
    assert len(res.losses) == 1 and np.isfinite(res.test_loss)
    assert "num_batches: 1" in (run / "test_result.txt").read_text()


def test_evaluate_takes_the_latest_run_dir_and_defaults_to_cuda(run_dirs, tmp_path):
    assert evaluate.parse_args([]).device == "cuda"
    assert evaluate.get_latest_model_dir(str(run_dirs["run"].parent)) == str(run_dirs["run"])
    with pytest.raises(FileNotFoundError, match="No model directories"):
        evaluate.get_latest_model_dir(str(tmp_path))

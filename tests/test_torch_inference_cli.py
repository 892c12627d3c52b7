"""The port's inference CLI (``python -m diffusion_model_project_tpu_torch.inference``)
on the CPU, on a tiny run dir in the reference layout (``best_model.pt`` and
a ``vae.pt`` VAE dir) written from the port's own seeded predictor; the
formats the JAX package writes are held in ``tests/test_torch_checkpoint.py``.

For each sampler the CLI's prediction must equal the port predictor's own
call from the same run dir with a ``torch.Generator`` seeded with
``seed + index``, on the test-split sample of the dataset or on a user
``.npz`` / ``.pt`` file; ``main`` writes the comparison PNG.
"""
import json

import numpy as np
import pytest
import torch

from diffusion_model_project_tpu_torch import inference
from diffusion_model_project_tpu_torch.data import get_loader
from diffusion_model_project_tpu_torch.diffusion.predictor import LatentDiffusionPredictor
from diffusion_model_project_tpu_torch.utils.checkpoint import predictor_from_directory

from test_torch_data import write_dataset
from test_torch_predictor import HW, LATENT, NORM_OUTPUT, S, UNET_KW, VAE_FEATURES
from test_torch_train_step import one_torch_thread  # noqa: F401

STEPS = 3
T = 20


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    pred = LatentDiffusionPredictor.create(dict(UNET_KW), seed=4, device="cpu", num_timesteps=T,
                                           latent_channels=LATENT, vae_features=VAE_FEATURES)
    torch.nn.init.normal_(pred.model.final_conv.weight, std=0.05,  # zero at init
                          generator=torch.Generator().manual_seed(5))
    pred.set_normalizer({"input": [1.0], "output": NORM_OUTPUT})
    run, vae = root / "run", root / "vae"
    run.mkdir()
    vae.mkdir()
    torch.save({k: v for k, v in pred.state_dict().items()
                if k.startswith(("model.", "normalizer."))}, run / "best_model.pt")
    torch.save(pred.vae.state_dict(), vae / "vae.pt")
    (vae / "vae_log.json").write_text(json.dumps({"norm_factors": NORM_OUTPUT}))
    data = write_dataset(root / "data", n=8, with_y=False, seed=5, hw=HW)
    predictor = {"model_name": "UNet", "model_kwargs": dict(UNET_KW), "distance_transform": True,
                 "num_slices": S, "num_timesteps": T, "vae_path": str(vae)}
    (run / "log.json").write_text(json.dumps({"params": {
        "dataset": {"root_dir": str(data)},
        "training": {"predictor_type": "latent-diffusion", "predictor": predictor}}}))
    return run


def _own_call(run, sampler, img, v2d, seed):
    pred, _ = predictor_from_directory(str(run), device="cpu")
    gen = torch.Generator().manual_seed(seed)
    img, v2d = torch.from_numpy(img), torch.from_numpy(v2d)
    if sampler == "ddim":
        return pred.predict_ddim(img, v2d, num_steps=STEPS, generator=gen).numpy()
    if sampler == "dpm":
        return pred.predict_dpm(img, v2d, num_steps=STEPS, generator=gen).numpy()
    return pred.predict(img, v2d, generator=gen).numpy()


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "dpm"])
def test_cli_equals_the_predictors_own_call(run_dir, sampler):
    index = 1
    res = inference.run(["--model-dir", str(run_dir), "--device", "cpu", "--sampler", sampler,
                         "--steps", str(STEPS), "--index", str(index)])
    (_, _, test), = get_loader(json.loads((run_dir / "log.json").read_text())
                               ["params"]["dataset"]["root_dir"], batch_size=1, use_3d=True)
    item = test.dataset[index]
    np.testing.assert_array_equal(res.img[0], item["microstructure"])
    np.testing.assert_array_equal(res.target[0], item["velocity"])
    expected = _own_call(run_dir, sampler, res.img, item["velocity_input"][None], 2024 + index)
    assert res.prediction.shape == (1, S, 3, HW, HW) and np.isfinite(res.prediction).all()
    np.testing.assert_array_equal(res.prediction, expected)
    assert not res.prediction[np.broadcast_to(res.img == 0, res.prediction.shape)].any()
    assert np.abs(res.prediction).max() > 0 and res.seconds > 0


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
def test_cli_takes_an_input_file(run_dir, tmp_path, suffix):
    rng = np.random.default_rng(9)
    sample = {"microstructure": (rng.random((S, 1, HW, HW)) > 0.4).astype(np.float32),
              "velocity_input": (rng.standard_normal((S, 3, HW, HW)) * 1e-2).astype(np.float32)}
    path = tmp_path / f"sample{suffix}"
    if suffix == ".npz":
        np.savez(path, **sample)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sample.items()}, path)
    res = inference.run(["--model-dir", str(run_dir), "--device", "cpu", "--sampler", "ddim",
                         "--steps", str(STEPS), "--input-file", str(path), "--seed", "7"])
    assert res.target is None
    expected = _own_call(run_dir, "ddim", sample["microstructure"][None],
                         sample["velocity_input"][None], 7)
    np.testing.assert_array_equal(res.prediction, expected)


def test_main_writes_the_png(run_dir, tmp_path):
    pytest.importorskip("matplotlib")
    out = tmp_path / "pred.png"
    inference.main(["--model-dir", str(run_dir), "--device", "cpu", "--sampler", "dpm",
                    "--steps", "2", "--output", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_cli_refuses_a_lone_split_flag(run_dir):
    with pytest.raises(SystemExit, match="must be given together"):
        inference.run(["--model-dir", str(run_dir), "--device", "cpu",
                       "--vae-encoder-path", str(run_dir)])

"""The port's end-to-end evaluation script
(``diffusion_model_project_tpu_torch/scripts/eval_testset_end2end.py``)
against the root script's ``run_evaluation``, on the CPU.

One tiny run dir in the reference layout (``best_model.pt`` and a ``vae.pt``
VAE dir, written from the port's seeded predictor with nonzero
``final_conv`` / ``proj_out``) and a dataset whose test split holds 3
samples. The root script (loaded from its file) and the port load it each
with their own loader and evaluate DDIM-2 from shared ``--noise-dir``
latents, ``--sanity-mode`` and ``--cross-mode``: per-sample ``nmae_total``
and ``cosine_similarity`` within 1e-4 relative, and the JSON reports carry
the same keys. In the port alone: DDIM at batch 1 and batch 2 (a padded
last chunk) give the same per-sample metrics, DDPM at batch 2 raises, the
noise is the reference's torch stream, ``run`` writes the report, and
``--int8`` runs the sampler on the int8 frozen VAE while ``--sanity-mode``
stays float.
"""
import importlib.util
import json
import math
import os.path as osp

import numpy as np
import pytest
import torch

from diffusion_model_project_tpu.data import get_loader as j_get_loader

from diffusion_model_project_tpu_torch.data import get_loader
from diffusion_model_project_tpu_torch.diffusion.predictor import LatentDiffusionPredictor
from diffusion_model_project_tpu_torch.models.layers import uniform_
from diffusion_model_project_tpu_torch.models.unet import SelfAttention2D
from diffusion_model_project_tpu_torch.scripts import eval_testset_end2end as port_eval

from test_torch_data import write_dataset
from test_torch_predictor import HW, LATENT, NORM_OUTPUT, S, UNET_KW, VAE_FEATURES
from test_torch_train_step import one_torch_thread  # noqa: F401

REPO = osp.abspath(osp.join(osp.dirname(__file__), ".."))
T = 50
STEPS = 2
MODES = {"ddim": {}, "sanity": {"sanity_mode": True}, "cross": {"cross_mode": True}}


def _root_script():
    spec = importlib.util.spec_from_file_location(
        "_root_eval_testset_end2end", osp.join(REPO, "scripts", "eval_testset_end2end.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e")
    pred = LatentDiffusionPredictor.create(dict(UNET_KW), seed=4, device="cpu", num_timesteps=T,
                                           latent_channels=LATENT, vae_features=VAE_FEATURES)
    gen = torch.Generator().manual_seed(5)  # final_conv and proj_out are zero at init
    uniform_(pred.model.final_conv.weight, 0.1, gen)
    for m in pred.model.modules():
        if isinstance(m, SelfAttention2D):
            uniform_(m.proj_out.weight, 0.1, gen)
    pred.set_normalizer({"input": [1.0], "output": NORM_OUTPUT})
    run, vae, noise = root / "run", root / "vae", root / "noise"
    for d in (run, vae, noise):
        d.mkdir()
    torch.save({k: v for k, v in pred.state_dict().items()
                if k.startswith(("model.", "normalizer."))}, run / "best_model.pt")
    torch.save(pred.vae.state_dict(), vae / "vae.pt")
    (vae / "vae_log.json").write_text(json.dumps({"norm_factors": NORM_OUTPUT}))
    predictor = {"model_name": "UNet", "model_kwargs": dict(UNET_KW), "distance_transform": True,
                 "num_slices": S, "num_timesteps": T, "vae_path": str(vae)}
    (run / "log.json").write_text(json.dumps({"params": {"training": {
        "predictor_type": "latent-diffusion", "predictor": predictor}}}))
    data = write_dataset(root / "data", n=12, with_y=False, seed=8, hw=HW)
    rng = np.random.default_rng(9)
    for i in range(3):
        np.save(noise / f"{i}.npy",
                rng.standard_normal((S, LATENT, HW // 4, HW // 4)).astype(np.float32))
    return {"run": str(run), "data": str(data), "noise": str(noise), "out": root / "out"}


def _argv(dirs, extra=()):
    return ["--diffusion-model-path", dirs["run"], "--dataset-dir", dirs["data"],
            "--steps", str(STEPS), "--noise-dir", dirs["noise"], *extra]


@pytest.fixture(scope="module")
def reports(dirs):
    """Both scripts' per-sample metrics and JSON reports in each mode."""
    root = _root_script()
    j_args = root.parse_args(_argv(dirs))
    (_, _, j_test), = j_get_loader(root_dir=dirs["data"], batch_size=1, use_3d=True, seed=2024)
    j_pred, j_nf = root.load_model_and_config(j_args, (HW, HW))
    p_args = port_eval.parse_args(_argv(dirs, ["--device", "cpu"]))
    (_, _, p_test), = get_loader(root_dir=dirs["data"], batch_size=1, use_3d=True, seed=2024)
    p_pred, p_nf = port_eval.load_model_and_config(p_args)
    assert tuple(p_nf) == tuple(j_nf) == tuple(NORM_OUTPUT)
    out = {}
    for mode, flags in MODES.items():
        kw = dict(sampler="ddim", num_steps=STEPS, seed=42, noise_dir=dirs["noise"], **flags)
        per_j, san_j = root.run_evaluation(j_pred, j_test.dataset, j_nf, **kw)
        per_p, san_p = port_eval.run_evaluation(p_pred, p_test.dataset, p_nf, **kw)
        paths = {}
        for side, mod, args, per, san in (("jax", root, j_args, per_j, san_j),
                                          ("port", port_eval, p_args, per_p, san_p)):
            args.sanity_mode = bool(flags.get("sanity_mode"))
            args.cross_mode = bool(flags.get("cross_mode"))
            out_dir = dirs["out"] / f"{mode}_{side}"
            out_dir.mkdir(parents=True)
            paths[side] = mod.save_results(per, mod.aggregate_results(per), san, args,
                                           str(out_dir))
        out[mode] = {"jax": per_j, "port": per_p, "paths": paths}
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_per_sample_metrics_match_the_root_script(reports, mode):
    jax_rows, port_rows = reports[mode]["jax"], reports[mode]["port"]
    assert [r["sample_id"] for r in port_rows] == [r["sample_id"] for r in jax_rows] == [0, 1, 2]
    for rj, rp in zip(jax_rows, port_rows):
        assert set(rp) == set(rj)
        for key in ("nmae_total", "cosine_similarity"):
            assert math.isfinite(rp[key]) and rp[key] != 0
            np.testing.assert_allclose(rp[key], rj[key], rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_reports_carry_the_root_scripts_keys(reports, mode):
    jax_rep, port_rep = (json.load(open(reports[mode]["paths"][side])) for side in ("jax", "port"))
    assert set(port_rep) == set(jax_rep)
    for key in ("evaluation_mode", "pipeline", "accuracy_definition"):
        assert port_rep[key] == jax_rep[key]
    for key in ("summary", "sanity_stats", "args"):
        assert set(port_rep[key]) == set(jax_rep[key]), key
    assert osp.basename(reports[mode]["paths"]["port"]).split("_2")[0] == \
        osp.basename(reports[mode]["paths"]["jax"]).split("_2")[0]


def test_batch_size_leaves_per_sample_results_alone(dirs, reports):
    args = port_eval.parse_args(_argv(dirs, ["--device", "cpu"]))
    pred, nf = port_eval.load_model_and_config(args)
    (_, _, test), = get_loader(root_dir=dirs["data"], batch_size=2, use_3d=True, seed=2024)
    rows = {}
    for bs in (1, 2):  # 3 samples at batch 2: the last chunk is padded
        rows[bs], _ = port_eval.run_evaluation(pred, test.dataset, nf, sampler="ddim",
                                               num_steps=STEPS, seed=42, batch_size=bs)
    assert [r["sample_id"] for r in rows[2]] == [0, 1, 2]
    for r1, r2 in zip(rows[1], rows[2]):
        np.testing.assert_allclose(r2["nmae_total"], r1["nmae_total"], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(r2["mae_total"], r1["mae_total"], rtol=1e-5, atol=1e-9)
    with pytest.raises(ValueError, match="--sampler ddpm requires --batch-size 1"):
        port_eval.run_evaluation(pred, test.dataset, nf, sampler="ddpm", batch_size=2)
    with pytest.raises(ValueError, match="exclusive"):
        port_eval.run_evaluation(pred, test.dataset, nf, sanity_mode=True, cross_mode=True)


def test_noise_is_the_references_torch_stream():
    state = torch.get_rng_state()
    got = port_eval.sample_noise(42, 3, (S, LATENT, 8, 8))
    assert torch.equal(torch.get_rng_state(), state)  # the global generator is untouched
    torch.manual_seed(45)
    expected = torch.randn(S, LATENT, 8, 8)
    torch.set_rng_state(state)
    assert torch.equal(got, expected)


def test_run_writes_the_report_and_refuses_int8(dirs, capsys):
    out_dir = str(dirs["out"] / "cli")
    res = port_eval.run(_argv(dirs, ["--device", "cpu", "--sampler", "dpm", "--num-samples", "2",
                                     "--output-dir", out_dir, "--save-csv", "r.csv",
                                     "--save-npz-preds", "--torch-noise"]))
    rep = json.load(open(res.json_path))
    assert rep["evaluation_mode"] == "END_TO_END_DIFFUSION"
    assert rep["pipeline"].startswith(f"2D input -> E2D -> DPM ({STEPS} steps)")
    assert [r["sample_id"] for r in rep["per_sample_results"]] == [0, 1]
    assert res.steady_seconds == rep["per_sample_results"][1]["time_sec"]
    assert osp.exists(osp.join(out_dir, "r.csv"))
    assert osp.exists(osp.join(out_dir, "predictions_npz", "pred_0001.npz"))
    printed = capsys.readouterr().out
    assert "[DIFF] Sample    1 (2/2)" in printed and "Steady-state (excl. first chunk)" in printed
    # --int8: the samplers on with_vae_int8(); the VAE-only modes call the VAE
    # directly and stay float, as in the JAX script
    one = ["--device", "cpu", "--index", "0"]
    runs = {(mode, q): port_eval.run(_argv(dirs, one + flags + (["--int8"] if q else []) + [
        "--output-dir", str(dirs["out"] / f"int8_{mode}_{q}")]))
        for mode, flags in (("ddim", []), ("sanity", ["--sanity-mode"])) for q in (0, 1)}
    assert "int8 frozen-VAE path enabled" in capsys.readouterr().out
    assert runs["ddim", 1].predictor.vae_int8 and not runs["ddim", 0].predictor.vae_int8
    metric = {k: r.per_sample[0]["nmae_total"] for k, r in runs.items()}
    assert np.isfinite(metric["ddim", 1]) and metric["ddim", 1] != metric["ddim", 0]
    assert metric["sanity", 1] == metric["sanity", 0]
    with pytest.raises(SystemExit):
        port_eval.parse_args(_argv(dirs, ["--vae-encoder-path", dirs["run"]]))
    assert port_eval.parse_args(_argv(dirs)).device == "cuda"


def test_precision_sets_torchs_float32_flags(dirs):
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        for precision, allow in (("highest", False), ("high", True), ("default", True)):
            port_eval.run(_argv(dirs, ["--device", "cpu", "--sanity-mode", "--index", "0",
                                       "--precision", precision,
                                       "--output-dir", str(dirs["out"] / precision)]))
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == (allow, allow)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

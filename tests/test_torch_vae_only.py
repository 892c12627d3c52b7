"""The port's VAE-only surface against the JAX package's, on the CPU:
``MicroFlowDatasetVAE``, ``VariationalAutoencoder``, the ``DualBranchVAE``
composite, cross and alignment paths, ``kl_divergence_sum`` and the
``inference_vae`` CLI.

Dataset items are equal to JAX's exactly, with and without flips (the
stateful stream and the ``set_epoch`` one). The modules take tiny JAX
VAE params, plain and FiLM-conditional, through ``utils/weights.py``; every deterministic
path is held at rtol 1e-4 / atol 1e-5, the stochastic ones to their
definition on the caller's generator. ``inference_vae.run`` in modes 2d, 3d
and cross equals the root script's ``encode_decode`` +
``masked_mae_per_component`` (loaded from its file) within 1e-4 relative,
and ``detect_model_type`` agrees with the root script's on every VAE dir
format ``tests/test_torch_checkpoint.py`` writes.
"""
import importlib.util
import json
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_project_tpu.data.dataset import MicroFlowDatasetVAE as JDatasetVAE
from diffusion_model_project_tpu.models.vae import (
    DualBranchVAE as JDualBranchVAE, VariationalAutoencoder as JVAE,
    kl_divergence_sum as j_kl_sum)
from diffusion_model_project_tpu.utils import checkpoint as jckpt
from diffusion_model_project_tpu.utils import torch_export as te

from diffusion_model_project_tpu_torch import inference_vae
from diffusion_model_project_tpu_torch.data import MicroFlowDatasetVAE
from diffusion_model_project_tpu_torch.models.vae import (
    DualBranchVAE, VariationalAutoencoder, kl_divergence_sum)
from diffusion_model_project_tpu_torch.utils import weights

from test_torch_checkpoint import write_vae_dir
from test_torch_data import write_dataset
from test_torch_predictor import LATENT, NORM_OUTPUT, S, VAE_FEATURES
from test_torch_train_step import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)
REPO = osp.abspath(osp.join(osp.dirname(__file__), ".."))


def _root_inference_vae():
    spec = importlib.util.spec_from_file_location("_root_inference_vae",
                                                  osp.join(REPO, "inference_vae.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), tree)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """JAX VAE params, plain and FiLM-conditional (FiLM weights perturbed off
    the identity): port modules with the JAX package's initializers, saved
    as a dual ``vae.pt`` and a standard conditional one and read back by the
    JAX package's own ``.pt`` importer."""
    out = {}
    for name, conditional in (("plain", False), ("conditional", True)):
        vae = DualBranchVAE(latent_channels=LATENT, features=VAE_FEATURES,
                            conditional=conditional)
        gen = torch.Generator().manual_seed(5)
        vae.init_parameters_(gen)
        sd = vae.state_dict()
        with torch.no_grad():
            for k, v in sd.items():
                if ".film" in k:
                    v += 0.05 * torch.randn(v.shape, generator=gen)
        if conditional:
            sd = {f"{half}.{k[len(branch) + 1:]}": v for k, v in sd.items()
                  for half, branch in (("encoder", "encoder_3d"), ("decoder", "decoder_3d"))
                  if k.startswith(branch + ".")}
        d = tmp_path_factory.mktemp(name)
        torch.save(sd, d / "vae.pt")
        (d / "vae_log.json").write_text(json.dumps({"conditional": conditional}))
        branches, _, flavor = jckpt.load_dual_vae_from_paths(str(d))
        assert flavor == ("standard_conditional" if conditional else "dual_full")
        out[name] = _np_tree(branches)
    return out


def _cf(a):
    """(B, D, H, W, C) -> (B, C, D, H, W) tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _assert_cf_close(got, expected_cl):
    np.testing.assert_allclose(got.detach().numpy(), np.moveaxis(np.asarray(expected_cl), -1, 1),
                               **TOL)


def _x(seed, b=2, d=S, hw=16):
    return np.random.default_rng(seed).standard_normal((b, d, hw, hw, 3)).astype(np.float32)


# ------------------------------------------------------------------ dataset


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return str(write_dataset(tmp_path_factory.mktemp("vae_data") / "data", n=3, with_y=True,
                             seed=3, hw=16))


def _assert_items_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("augment", [False, True])
def test_vae_dataset_items_equal_jax(data_dir, augment):
    jds, ds = JDatasetVAE(data_dir, augment=augment, seed=4), MicroFlowDatasetVAE(
        data_dir, augment=augment, seed=4)
    assert len(ds) == len(jds) == 12 and ds.num_microstructures == 6
    for idx in range(len(ds)):  # the stateful stream, in index order
        _assert_items_equal(ds[idx], jds[idx])
    for epoch in (0, 3):
        jds.set_epoch(epoch)
        ds.set_epoch(epoch)
        for idx in (11, 0, 7):
            _assert_items_equal(ds[idx], jds[idx])
    item = MicroFlowDatasetVAE(data_dir)[1]
    assert item["velocity"].shape == (3, S, 16, 16) and bool(item["is_2d"])
    assert int(item["original_idx"]) == 1


# ------------------------------------------------------------------ modules


def _port_vae(params, conditional=False):
    vae = DualBranchVAE(latent_channels=LATENT, features=VAE_FEATURES, conditional=conditional)
    vae.load_state_dict(weights.to_tensors(weights.export_dual_vae(params)), strict=True)
    return vae.eval()


def _apply(module, params, method, *args):
    """``method(module, *args)`` under ``params``, in one compile."""
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a, method=method))(params, *args)


@pytest.mark.parametrize("conditional", [False, True])
def test_variational_autoencoder_matches_jax(sources, conditional):
    vp = sources["conditional" if conditional else "plain"]
    params = {"encoder": vp["encoder_3d"], "decoder": vp["decoder_3d"]}
    jvae = JVAE(latent_channels=LATENT, features=VAE_FEATURES, conditional=conditional)
    vae = VariationalAutoencoder(latent_channels=LATENT, features=VAE_FEATURES,
                                 conditional=conditional)
    sd = {f"{half}.{k}": v for half, branch in (("encoder", "encoder_3d"), ("decoder", "decoder_3d"))
          for k, v in weights.export_vae_branch(branch, params[half]).items()}
    vae.load_state_dict(weights.to_tensors(sd), strict=True)  # the standard flavour's keys
    x = _x(1)
    cond = np.array([0.0, 1.0], np.float32) if conditional else None
    j_args = (x,) if cond is None else (x, cond)
    p_cond = None if cond is None else torch.from_numpy(cond)
    (mu_j, (_, logvar_j)), rec_j = _apply(
        jvae, params, lambda m, x, *c: (m.encode_deterministic(x, *c),
                                        m.decode(m.encode_deterministic(x, *c)[0], *c)), *j_args)
    with torch.no_grad():
        mu, (_, logvar) = vae.encode_deterministic(_cf(x), p_cond)
        _assert_cf_close(mu, mu_j)
        _assert_cf_close(logvar, logvar_j)
        _assert_cf_close(vae.decode(_cf(mu_j), p_cond), rec_j)
        # the stochastic encode: mu + exp(logvar / 2) * eps, eps from the generator
        z, _ = vae.encode(_cf(x), torch.Generator().manual_seed(2), p_cond)
        eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(2))
        torch.testing.assert_close(z, mu + torch.exp(0.5 * logvar) * eps)
        rec, _ = vae(_cf(x), torch.Generator().manual_seed(2), p_cond)
        torch.testing.assert_close(rec, vae.decode(z, p_cond))


def test_dual_branch_composite_paths_match_jax(sources):
    vp = sources["plain"]
    jvae = JDualBranchVAE(latent_channels=LATENT, features=VAE_FEATURES)
    vae = _port_vae(vp)
    x2, x3 = _x(2), _x(3)
    (rec_j, mu_j), (cross_j, z_j), expected = _apply(
        jvae, vp, lambda m, a, b: (m.forward_2d_deterministic(a), m.forward_cross_2d_to_3d(a),
                                   m.compute_alignment_loss(a, b)), x2, x3)
    with torch.no_grad():
        rec, mu = vae.forward_2d_deterministic(_cf(x2))
        _assert_cf_close(rec, rec_j)
        _assert_cf_close(mu, mu_j)
        assert not rec[:, 2].any()  # w == 0 on the 2D branch
        rec, z = vae.forward_cross_2d_to_3d(_cf(x2))
        _assert_cf_close(rec, cross_j)
        _assert_cf_close(z, z_j)
        for mode in ("symmetric", "one_way", "stop_grad"):
            got = vae.compute_alignment_loss(_cf(x2), _cf(x3), mode).item()
            np.testing.assert_allclose(got, float(expected), **TOL)
        with pytest.raises(ValueError, match="Unknown alignment mode"):
            vae.compute_alignment_loss(_cf(x2), _cf(x3), "both")

        # the stochastic paths, on the caller's generator
        def z_of(encode, x, seed):
            _, (m, lv) = encode(x, torch.Generator().manual_seed(seed))
            eps = torch.randn(m.shape, generator=torch.Generator().manual_seed(seed))
            return m + torch.exp(0.5 * lv) * eps

        g = lambda: torch.Generator().manual_seed(9)  # noqa: E731
        torch.testing.assert_close(vae.predict_2d_to_3d(_cf(x2), g()),
                                   vae.decode_3d(z_of(vae.encode_2d, _cf(x2), 9)))
        torch.testing.assert_close(vae.forward_2d(_cf(x2), g())[0],
                                   vae.decode_2d(z_of(vae.encode_2d, _cf(x2), 9)))
        torch.testing.assert_close(vae.forward_3d(_cf(x3), g())[0],
                                   vae.decode_3d(z_of(vae.encode_3d, _cf(x3), 9)))
        rec, z = vae.forward_cross_3d_to_2d(_cf(x3), g())
        torch.testing.assert_close(z, z_of(vae.encode_3d, _cf(x3), 9))
        torch.testing.assert_close(rec, vae.decode_2d(z))


@pytest.mark.parametrize("mode", ["symmetric", "one_way", "stop_grad"])
def test_alignment_loss_gradients(sources, mode):
    vae = _port_vae(sources["plain"])
    vae.compute_alignment_loss(_cf(_x(2, b=1)), _cf(_x(3, b=1)), mode).backward()
    e2d = vae.encoder_2d.conv_out.weight.grad
    e3d = vae.encoder_3d.conv_out.weight.grad
    assert e2d is not None and e2d.abs().max() > 0
    assert (e3d is not None and e3d.abs().max() > 0) == (mode == "symmetric")


def test_kl_divergence_sum_matches_jax():
    rng = np.random.default_rng(4)
    mu = rng.standard_normal((2, LATENT, 3, 4, 4)).astype(np.float32)
    logvar = rng.uniform(-3, 2, mu.shape).astype(np.float32)
    np.testing.assert_allclose(kl_divergence_sum(torch.from_numpy(mu), torch.from_numpy(logvar)),
                               np.asarray(j_kl_sum(mu, logvar)), rtol=1e-5)


# ------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def vae_dir(sources, tmp_path_factory):
    d = tmp_path_factory.mktemp("vae_cli")
    te.save_torch_state_dict(te.export_dual_vae(sources["plain"]), str(d / "vae.pt"))
    (d / "vae_log.json").write_text(json.dumps({"norm_factors": NORM_OUTPUT,
                                                "latent_channels": LATENT}))
    return str(d)


@pytest.mark.parametrize("mode", ["2d", "3d", "cross"])
def test_inference_vae_matches_the_root_script(vae_dir, data_dir, mode, tmp_path):
    root = _root_inference_vae()
    vae, params, nf, _ = root.load_vae(vae_dir)
    ds = JDatasetVAE(data_dir)
    n, index = ds.num_microstructures, 2
    to_cl = lambda x: jnp.moveaxis(jnp.asarray(x)[None], 1, -1)  # noqa: E731
    nf = np.asarray(nf, np.float32)
    v2d, v3d = to_cl(ds[index]["velocity"]) / nf, to_cl(ds[index + n]["velocity"]) / nf
    mask = np.asarray(to_cl(ds[index + (n if mode != "2d" else 0)]["microstructure"]))
    recon, _, target = (np.asarray(a) for a in jax.jit(
        lambda p, a, b: root.encode_decode(vae, p, mode, a, b))(params, v2d, v3d))
    expected = root.masked_mae_per_component(recon * mask, target * mask, mask)

    res = inference_vae.run(["--vae-path", vae_dir, "--dataset-dir", data_dir, "--mode", mode,
                             "--index", str(index), "--device", "cpu"])
    assert res.model_type == "dual_full" and res.flavor == "dual_full"
    assert set(res.metrics) == set(expected)
    assert expected["mae_total"] > 0 and (expected["mae_w"] == 0) == (mode == "2d")
    for k, v in expected.items():
        np.testing.assert_allclose(res.metrics[k], v, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(res.recon, np.moveaxis(recon * mask, -1, 1),
                               rtol=0, atol=1e-4 * np.abs(recon).max())
    if mode == "cross":
        pytest.importorskip("matplotlib")
        inference_vae.main(["--vae-path", vae_dir, "--dataset-dir", data_dir, "--mode", mode,
                            "--device", "cpu", "--output-dir", str(tmp_path)])
        for panel in ("triptych", "latent", "wstrip"):
            png = tmp_path / f"vae_cross_{panel}_0.png"
            assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


FORMATS = ["native", "pt", "dual_stage1_3d", "split_mixed", "standard", "standard_conditional",
           "legacy_layers", "whole_module"]


@pytest.mark.parametrize("flavour", FORMATS)
def test_detect_model_type_agrees_with_the_root_script(sources, flavour, tmp_path):
    root = _root_inference_vae()
    write_vae_dir(tmp_path, flavour, sources[
        "conditional" if flavour == "standard_conditional" else "plain"])
    folders = [tmp_path / "vae"] + ([tmp_path / "stage2"] if flavour == "split_mixed" else [])
    types = []
    for folder in folders:
        expected = root.detect_model_type(str(folder))
        assert inference_vae.detect_model_type(str(folder)) == expected
        types.append(expected)
    assert types == {"native": ["dual_full"], "pt": ["dual_full"],
                     "dual_stage1_3d": ["dual_stage1_3d_only"],
                     "split_mixed": ["dual_stage1_3d_only", "dual_stage2"],
                     "whole_module": ["dual_full"]}.get(flavour, ["standard"])


def test_load_vae_takes_the_conditional_standard_flavour(sources, tmp_path, data_dir):
    write_vae_dir(tmp_path, "standard_conditional", sources["conditional"])
    vae, norm, flavor = inference_vae.load_vae(str(tmp_path / "vae"), LATENT, device="cpu")
    assert flavor == "standard_conditional" and vae.conditional and norm == NORM_OUTPUT
    res = inference_vae.run(["--vae-path", str(tmp_path / "vae"), "--dataset-dir", data_dir,
                             "--latent-channels", str(LATENT), "--device", "cpu"])
    assert res.flavor == "standard_conditional" and np.isfinite(res.metrics["mae_total"])
    assert inference_vae.parse_args(["--vae-path", "v", "--dataset-dir", "d"]).device == "cuda"


def test_vae_config_parser_matches_jax():
    from diffusion_model_project_tpu.utils import vae_config as j_vae_config

    from diffusion_model_project_tpu_torch.utils import vae_config

    argv = ["--latent-channels", "4", "--conditional", "--no-per-component-norm",
            "--vz-weight", "2.5", "--augment"]
    for args in ([], argv):
        assert vars(vae_config.parser.parse_args(args)) == vars(
            j_vae_config.parser.parse_args(args))

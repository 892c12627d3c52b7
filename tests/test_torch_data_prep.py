"""The port's data preparation (``data/split.py``, ``data/statistics.py`` and
the CLIs ``scripts/data_split.py`` / ``scripts/generate_statistics.py``)
against the JAX package's, on the CPU: split membership and files equal, and
``statistics.json`` equal key for key and value for value but for the
``generated`` timestamp, on a dataset written by numpy from a seed.
"""
import json
import os
import os.path as osp
import shutil

import numpy as np
import pytest

from diffusion_model_project_tpu.data import split as jsplit
from diffusion_model_project_tpu.data import statistics as jstats

from diffusion_model_project_tpu_torch.data import split, statistics
from diffusion_model_project_tpu_torch.scripts import data_split as split_cli
from diffusion_model_project_tpu_torch.scripts import generate_statistics as stats_cli

from test_torch_train_step import one_torch_thread  # noqa: F401
from test_torch_vae_train import write_dataset


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A 12-sample dataset (x/*.pt only; no split or statistics yet)."""
    root = str(tmp_path_factory.mktemp("prep") / "d")
    write_dataset(root, n=12, seed=11)
    for name in ("splits.json", "statistics.json"):
        os.remove(osp.join(root, name))
    return root


def _copy(dataset, tmp_path, name):
    out = str(tmp_path / name)
    shutil.copytree(dataset, out)
    return out


@pytest.mark.parametrize("n,ratios,seed", [(12, (0.7, 0.15, 0.15), 2024),
                                           (37, (0.6, 0.2, 0.2), 7),
                                           (1, (0.7, 0.15, 0.15), 2024)])
def test_splits_match_jax(n, ratios, seed):
    assert split.create_split(n, *ratios, seed=seed) == jsplit.create_split(n, *ratios, seed=seed)
    ids = split.compute_sample_ids(n)
    assert ids == jsplit.compute_sample_ids(n)
    assert split.create_split(n, *ratios, seed=seed, sample_ids=ids) == \
        jsplit.create_split(n, *ratios, seed=seed, sample_ids=ids)
    paired = split.create_paired_split_for_vae(n, *ratios, seed=seed)
    assert paired == jsplit.create_paired_split_for_vae(n, *ratios, seed=seed)
    assert split.get_3d_only_split(paired, n) == jsplit.get_3d_only_split(paired, n)


def test_get_or_create_split_and_consistency_match_jax(tmp_path, capsys):
    for pkg, name in ((split, "port"), (jsplit, "jax")):
        d = tmp_path / name
        d.mkdir()
        created = pkg.get_or_create_split(str(d), 20)
        assert pkg.get_or_create_split(str(d), 20) == created  # loaded, not re-created
        assert pkg.get_or_create_split(str(d), 20, filter_indices=[1, 4, 9, 13, 19])["train"] \
            == jsplit.get_or_create_split(str(d), 20, filter_indices=[1, 4, 9, 13, 19])["train"]
        regenerated = pkg.get_or_create_split(str(d), 25)  # size mismatch: regenerate
        assert regenerated["metadata"]["num_samples"] == 25
        assert "regenerating" in capsys.readouterr().out
    for f in ("splits.json",):
        assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text()
    vae_path, diff_path = str(tmp_path / "vae.json"), str(tmp_path / "diff.json")
    split.save_split(split.create_paired_split_for_vae(10), vae_path)
    split.save_split(split.create_split(10), diff_path)
    assert split.verify_split_consistency(vae_path, diff_path) is True
    split.save_split(split.create_split(10, seed=1), diff_path)
    assert split.verify_split_consistency(vae_path, diff_path) is \
        jsplit.verify_split_consistency(vae_path, diff_path) is False


def test_data_split_cli_matches_jax(dataset, tmp_path, capsys):
    port, jax_dir = _copy(dataset, tmp_path, "port"), _copy(dataset, tmp_path, "jax")
    for argv in (["--generate", "--paired-vae"], ["--generate", "--output", "plain.json"]):
        assert split_cli.main(["--dataset-dir", port, *argv]) == 0
        assert jsplit.main(["--dataset-dir", jax_dir, *argv]) == 0
    for f in ("splits.json", "plain.json"):
        assert open(osp.join(port, f)).read() == open(osp.join(jax_dir, f)).read()
    before = open(osp.join(port, "splits.json")).read()
    # an existing split file is overwritten only with --force
    assert split_cli.main(["--dataset-dir", port, "--generate", "--seed", "3"]) == 1
    assert open(osp.join(port, "splits.json")).read() == before
    assert split_cli.main(["--dataset-dir", port, "--generate", "--seed", "3", "--force"]) == 0
    assert json.load(open(osp.join(port, "splits.json")))["metadata"]["seed"] == 3
    assert split_cli.main(["--dataset-dir", port, "--verify"]) == 0
    assert "Train: 8 samples" in capsys.readouterr().out
    assert split_cli.main(["--dataset-dir", str(tmp_path), "--verify"]) == 1


def _without_timestamp(stats: dict) -> dict:
    meta = dict(stats["metadata"])
    assert meta.pop("generated")
    return {**stats, "metadata": meta}


def test_generate_statistics_matches_jax(dataset, tmp_path, capsys):
    """--generate-split: splits.json and statistics.json (train-only maxima,
    masked means, std, percentiles, median, MAD of U and U_2d; p, dxyz; the
    metadata block) equal the JAX package's; then from the existing split,
    and an existing statistics.json kept without --force."""
    port, jax_dir = _copy(dataset, tmp_path, "port"), _copy(dataset, tmp_path, "jax")
    got = stats_cli.main(["--dataset-dir", port, "--generate-split"])
    want = jstats.generate_statistics(jax_dir, generate_split=True)
    assert _without_timestamp(got) == _without_timestamp(want)
    assert open(osp.join(port, "splits.json")).read() == \
        open(osp.join(jax_dir, "splits.json")).read()
    with open(osp.join(port, "statistics.json")) as f:
        assert _without_timestamp(json.load(f)) == _without_timestamp(want)
    assert set(got) == {"U", "U_per_component", "U_2d", "U_2d_per_component", "p", "dxyz",
                        "metadata"}

    # the split on disk is used as it is (here a 3-sample training split)
    split.save_split(split.create_split(12, 0.25, 0.25, 0.5, seed=5),
                     osp.join(port, "other.json"))
    shutil.copy(osp.join(port, "other.json"), osp.join(jax_dir, "other.json"))
    got = statistics.generate_statistics(port, split_file="other.json", force=True)
    want = jstats.generate_statistics(jax_dir, split_file="other.json", force=True)
    assert _without_timestamp(got) == _without_timestamp(want)
    assert got["metadata"]["num_train_samples"] == 3
    kept = statistics.generate_statistics(port, split_file="splits.json")
    assert kept == got and "exists" in capsys.readouterr().out


def test_velocity_statistics_match_jax():
    rng = np.random.default_rng(2)
    v5 = rng.standard_normal((4, 3, 3, 8, 8)).astype(np.float32)
    m5 = (rng.random((4, 3, 1, 8, 8)) > 0.4).astype(np.float32)
    v4 = rng.standard_normal((5, 2, 8, 8)).astype(np.float32)
    for args in ((v5, m5, "U"), (v5, None, "U_2d"), (v4, None, "U")):
        assert statistics.compute_velocity_statistics(*args) == \
            jstats.compute_velocity_statistics(*args)

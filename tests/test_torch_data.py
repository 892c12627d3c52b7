"""The port's dataset (``data/dataset.py``) against the JAX package's, on the CPU.

One synthetic ``.pt`` dataset in the reference layout (``x/`` and a rotated
``y/``) is copied twice, since ``get_loader`` writes ``statistics.json`` into
the dataset dir; each package's ``get_loader`` reads its own copy. Split
membership, every item (augmented where the training loader augments) and
``statistics.json`` must be identical.
"""
import json
import shutil

import numpy as np
import pytest
import torch

from diffusion_model_project_tpu.data import dataset as jdataset

from diffusion_model_project_tpu_torch.data import dataset

from test_torch_train_step import one_torch_thread  # noqa: F401

N, S, H, W = 10, 3, 8, 8


def write_dataset(root, n=N, with_y=True, seed=0, hw=H):
    """A dataset of n samples of S slices of hw^2 in the reference's .pt
    layout (root/x/*.pt, and root/y/*.pt where ``with_y``)."""
    rng = np.random.default_rng(seed)
    for sub in (("x", "y") if with_y else ("x",)):
        d = root / sub
        d.mkdir(parents=True)
        dom = (rng.random((n, S, 1, hw, hw)) > 0.3).astype(np.float32)
        u2d = rng.standard_normal((n, S, 3, hw, hw)).astype(np.float32)
        u2d[:, :, 2] = 0.0
        fields = {"domain.pt": dom, "U_2d.pt": u2d,
                  "U.pt": rng.standard_normal((n, S, 3, hw, hw)).astype(np.float32),
                  "p.pt": rng.standard_normal((n, S, 1, hw, hw)).astype(np.float32),
                  "dxyz.pt": rng.random((n, 3)).astype(np.float32),
                  "permeability.pt": rng.random((n, 1)).astype(np.float32)}
        for name, arr in fields.items():
            torch.save(torch.from_numpy(arr), d / name)
    return root


@pytest.fixture(scope="module")
def copies(tmp_path_factory):
    src = write_dataset(tmp_path_factory.mktemp("data") / "src")
    out = {}
    for name in ("jax", "port"):
        out[name] = tmp_path_factory.mktemp(name) / "data"
        shutil.copytree(src, out[name])
    return out


def _assert_items_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("use_3d", [True, False])
def test_get_loader_matches_jax(copies, use_3d):
    kw = dict(batch_size=3, use_3d=use_3d, seed=2024, augment=True)
    (jl,) = jdataset.get_loader(str(copies["jax"]), **kw)
    (pl,) = dataset.get_loader(str(copies["port"]), **kw)
    for jload, pload in zip(jl, pl):
        jd, pd = jload.dataset, pload.dataset
        assert len(jd) == len(pd) > 0
        for k in jd.data:  # membership: the same samples, in the same order
            np.testing.assert_array_equal(np.asarray(jd.data[k]), np.asarray(pd.data[k]))
        assert set(jd.data) == set(pd.data)
        for i in range(len(jd)):  # items, augmented on the training split
            _assert_items_equal(jd[i], pd[i])
        for jb, pb in zip(jload, pload):  # batches, shuffled on the training split
            _assert_items_equal(jb, pb)
    stats = [json.loads((copies[name] / "statistics.json").read_text()) for name in copies]
    assert stats[0] == stats[1]


def test_splits_json_and_k_folds_match_jax(copies, tmp_path):
    split = {"train": [0, 3, 5, 19, 40], "val": [1, 2], "test": [4, 7, 30]}
    split_file = tmp_path / "splits.json"
    split_file.write_text(json.dumps(split))
    for kw in (dict(split_file=str(split_file)), dict(k_folds=3)):
        jl = jdataset.get_loader(str(copies["jax"]), batch_size=2, use_3d=True, **kw)
        pl = dataset.get_loader(str(copies["port"]), batch_size=2, use_3d=True, **kw)
        assert len(jl) == len(pl)
        for jfold, pfold in zip(jl, pl):
            for jload, pload in zip(jfold, pfold):
                for k in jload.dataset.data:
                    np.testing.assert_array_equal(jload.dataset.data[k], pload.dataset.data[k])


def test_blind_dataset_and_loader_match_jax():
    rng = np.random.default_rng(3)
    data = {"microstructure": rng.random((5, S, 1, H, W)).astype(np.float32),
            "dxyz": rng.random((5, 3)).astype(np.float32)}
    jb, pb = jdataset.BlindDataset(data), dataset.BlindDataset(data)
    assert len(jb) == len(pb) == 5
    for jbatch, pbatch in zip(jdataset.NumpyLoader(jb, 2, shuffle=True, seed=1),
                              dataset.NumpyLoader(pb, 2, shuffle=True, seed=1)):
        _assert_items_equal(jbatch, pbatch)
    with pytest.raises(ValueError, match="dxyz"):
        dataset.BlindDataset({"microstructure": data["microstructure"]})


@pytest.mark.parametrize("make", ["missing", "empty"])
def test_missing_or_empty_dataset_dir_names_the_zenodo_record(tmp_path, make):
    root = tmp_path / "data"
    if make == "empty":
        root.mkdir()
    with pytest.raises(FileNotFoundError, match="Zenodo record 18341260"):
        dataset.get_loader(str(root), use_3d=True)
    assert not root.exists() or not any(root.iterdir())  # nothing downloaded or written


def test_a_missing_field_file_raises(tmp_path):
    root = write_dataset(tmp_path / "data", with_y=False)
    (root / "x" / "U_2d.pt").unlink()
    with pytest.raises(FileNotFoundError, match="U_2d.pt"):
        dataset.get_loader(str(root), use_3d=True)

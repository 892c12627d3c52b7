"""The diffusion pipeline's dataset, inference side: the port's own copy of
the JAX package's ``data/dataset.py`` (``MicroFlowDataset``, ``BlindDataset``,
``NumpyLoader``, ``get_loader``).

The reference's contract (Diffusion_model/utils/dataset.py): ``MicroFlowDataset``
over ``<root>/x/*.pt`` (+ optional ``<root>/y`` rotated 90 degrees with a
channel swap and a vy sign flip), on-the-fly flip augmentation with velocity
component sign flips, ``statistics.json`` written from the training subset,
the 70/15/15 split from ``splits.json`` or ``random.Random(seed)`` (seed
2024), optional k-fold. Data lives in host numpy; batches are dicts of numpy
arrays. A missing or empty dataset dir raises (the JAX package downloads the
Zenodo record there). ``MicroFlowDatasetVAE`` is the VAE view (reference
VAE_model/utils/dataset.py): the index space doubled to 2N, 2D samples then
3D ones, each item (C, D, H, W). The split and statistics writers live in
``split.py`` and ``statistics.py``; the paired VAE view (the VAE trainers'
``PairedDataset`` stands in for it) and ``paired_sampler.py`` are not
ported yet.
"""
from __future__ import annotations

import json
import os
import os.path as osp
import random
import re
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

# the dataset's Zenodo record (reference Diffusion_model/utils/zenodo.py:13-19)
ZENODO_RECORD = "18341260"


def _load_pt(path: str) -> np.ndarray:
    """Deserialize one .pt tensor to numpy.

    First load writes a sibling ``.npy_cache/<name>.<size>.<mtime_ns>.npy``;
    later loads memory-map it read-only (no pickle parse, lazy page-in, which
    matters at the real dataset's 2.1 GB). Per-sample ``astype`` copies
    downstream, so the read-only mapping never leaks into mutable code
    paths. The source file's size+mtime is part of the cache name, so edits
    invalidate it. Set DIFFUSION_TPU_NPY_CACHE=0 to disable; cache writes
    fail soft on read-only dataset dirs. The cache is the JAX package's
    format: the two packages share it."""
    if os.environ.get("DIFFUSION_TPU_NPY_CACHE", "1") != "0":
        try:
            st = os.stat(path)
            cache_dir = osp.join(osp.dirname(path), ".npy_cache")
            name = osp.basename(path)
            cache = osp.join(cache_dir,
                             f"{name}.{st.st_size}.{st.st_mtime_ns}.npy")
            if osp.exists(cache):
                return np.load(cache, mmap_mode="r")
        except OSError:
            cache = None
    else:
        cache = None

    data = torch.load(path, map_location="cpu", weights_only=False)
    arr = np.asarray(data.detach().cpu().numpy() if hasattr(data, "detach") else data)
    if cache is not None:
        try:
            os.makedirs(cache_dir, exist_ok=True)
            for stale in os.listdir(cache_dir):
                if not stale.startswith(name + ".") or not stale.endswith(".npy"):
                    continue
                if ".tmp" in stale:
                    # a crashed/SIGKILLed writer's orphan (can be ~GB at real
                    # dataset scale). Reclaim it only when its owning pid is
                    # dead — a LIVE concurrent process (multi-host training)
                    # may still be np.save-ing into it right now.
                    m = re.search(r"\.tmp(\d+)\.npy$", stale)
                    owner_alive = False
                    if m:
                        try:
                            os.kill(int(m.group(1)), 0)
                            owner_alive = True
                        except ProcessLookupError:
                            pass
                        except OSError:  # EPERM etc: exists but not ours
                            owner_alive = True
                    if not owner_alive:
                        try:
                            os.remove(osp.join(cache_dir, stale))
                        except OSError:
                            pass
                    continue
                # completed entries for THIS source with a DIFFERENT
                # size/mtime key; never the current key
                if stale != osp.basename(cache):
                    try:
                        os.remove(osp.join(cache_dir, stale))
                    except OSError:
                        pass
            tmp = cache + f".tmp{os.getpid()}.npy"  # np.save keeps .npy names
            np.save(tmp, arr)
            os.replace(tmp, cache)
            return np.load(cache, mmap_mode="r")
        except OSError:
            pass
    return arr


def _rotate_y_field(x: np.ndarray) -> np.ndarray:
    """Rotate fields of y-direction simulations into the x convention:
    rot90 + (u,v) channel swap + new-vy sign flip (reference dataset.py:440-460).

    Handles both 4-D (N, C, H, W) and 5-D (N, S, C, H, W) layouts — the
    channel axis is 2 for 5-D use_3d data (the reference's 4-value unpack
    crashes on 5-D inputs)."""
    ch_axis = 2 if x.ndim == 5 else 1
    num_channels = x.shape[ch_axis]
    x = np.rot90(x, k=1, axes=(-2, -1)).copy()
    if num_channels != 1:
        if x.ndim == 5:
            x = x[:, :, [1, 0, 2]]
            x[:, :, 1] = -x[:, :, 1]
        else:
            x = x[:, [1, 0, 2]]
            x[:, 1] = -x[:, 1]
    return x


_META_3D = {
    "microstructure": "domain.pt",
    "velocity_input": "U_2d.pt",
    "velocity": "U.pt",
    "pressure": "p.pt",
    "dxyz": "dxyz.pt",
}
_META_2D = {
    "microstructure": "domain.pt",
    "velocity": "U.pt",
    "pressure": "p.pt",
    "dxyz": "dxyz.pt",
}
_OPTIONAL = {"permeability": "permeability.pt"}


class MicroFlowDataset:
    """Steady-state micro-flow dataset (diffusion-pipeline view)."""

    def __init__(
        self,
        root_dir: str,
        augment: bool = False,
        use_3d: bool = False,
        data: Optional[Dict[str, np.ndarray]] = None,
        save_stats: bool = False,
        seed: int = 0,
    ):
        self.root_dir = root_dir
        self.augment = augment
        self.use_3d = use_3d
        self.save_stats = save_stats
        self._seed = seed
        self._epoch: Optional[int] = None
        self._rng = np.random.default_rng(seed)
        self.data: Dict[str, np.ndarray] = {}

        if data is not None:
            self.data = data
            if self.save_stats:
                self._save_statistics()
        else:
            if not osp.isdir(self.root_dir) or not os.listdir(self.root_dir):
                # the JAX package downloads the dataset here; the port reads
                # only what is on disk
                raise FileNotFoundError(
                    f"No dataset in {self.root_dir!r}: download and unzip dataset_3d.zip "
                    f"of Zenodo record {ZENODO_RECORD} (https://zenodo.org/records/"
                    f"{ZENODO_RECORD}) so that it holds x/*.pt")
            self.process()

    # ------------------------------------------------------------------ io

    def process(self) -> None:
        meta = _META_3D if self.use_3d else _META_2D
        data_x: Dict[str, np.ndarray] = {}
        for key, fname in meta.items():
            path = osp.join(self.root_dir, "x", fname)
            if not osp.exists(path):
                raise FileNotFoundError(f"Required file not found: {path}")
            data_x[key] = _load_pt(path)
        for key, fname in _OPTIONAL.items():
            path = osp.join(self.root_dir, "x", fname)
            if osp.exists(path):
                data_x[key] = _load_pt(path)

        data_y: Dict[str, np.ndarray] = {}
        has_y = True
        for key, fname in meta.items():
            path = osp.join(self.root_dir, "y", fname)
            if not osp.exists(path):
                has_y = False
                break
            arr = _load_pt(path)
            if key in ("microstructure", "velocity", "pressure"):
                arr = _rotate_y_field(arr)
            data_y[key] = arr
        if has_y:
            for key, fname in _OPTIONAL.items():
                path = osp.join(self.root_dir, "y", fname)
                if osp.exists(path):
                    data_y[key] = _load_pt(path)
            self.data = {
                k: np.concatenate([data_x[k], data_y[k]], axis=0) if k in data_y else data_x[k]
                for k in data_x
            }
        else:
            self.data = data_x

        if self.save_stats:
            self._save_statistics()

    def _save_statistics(self) -> None:
        """statistics.json with global + per-component maxima (reference
        dataset.py:344-438); written from whatever subset this dataset holds
        (the training subset in get_loader)."""
        stats: Dict = {}
        if "velocity" in self.data:
            v = self.data["velocity"]
            stats["U"] = {"max": float(np.abs(v).max())}
            if self.use_3d:
                stats["U_per_component"] = {
                    "max_u": float(np.abs(v[:, :, 0]).max()),
                    "max_v": float(np.abs(v[:, :, 1]).max()),
                    "max_w": float(np.abs(v[:, :, 2]).max()),
                    "description": "Per-component max for target velocity (vx, vy, vz)",
                    "std_u": float(v[:, :, 0].std(ddof=1)),
                    "std_v": float(v[:, :, 1].std(ddof=1)),
                    "std_w": float(v[:, :, 2].std(ddof=1)),
                }
            else:
                stats["U_per_component"] = {
                    "max_u": float(np.abs(v[:, 0]).max()),
                    "max_v": float(np.abs(v[:, 1]).max()),
                    "description": "Per-component max for target velocity (vx, vy)",
                }
        if "velocity_input" in self.data:
            vi = self.data["velocity_input"]
            stats["U_2d"] = {"max": float(np.abs(vi).max())}
            if self.use_3d:
                stats["U_2d_per_component"] = {
                    "max_u": float(np.abs(vi[:, :, 0]).max()),
                    "max_v": float(np.abs(vi[:, :, 1]).max()),
                    "max_w": float(np.abs(vi[:, :, 2]).max()),
                    "description": "Per-component max for input velocity (vx, vy, vz). Note: vz should be 0.",
                }
        if "pressure" in self.data:
            stats["p"] = {"max": float(np.abs(self.data["pressure"]).max())}
        if "dxyz" in self.data:
            stats["dxyz"] = {"max": float(np.abs(self.data["dxyz"]).max())}
        with open(osp.join(self.root_dir, "statistics.json"), "w") as f:
            json.dump(stats, f, indent=0)

    # -------------------------------------------------------------- access

    def __len__(self) -> int:
        return self.data["microstructure"].shape[0]

    def set_epoch(self, epoch: int) -> None:
        """Derive this epoch's augmentation stream from (seed, epoch, idx)
        instead of the stateful default: a resumed run replays exactly the
        same flips an uninterrupted run would have drawn (deterministic
        resume). Without set_epoch the legacy stateful stream is kept."""
        self._epoch = int(epoch)

    def _aug_rng(self, idx: int):
        if self._epoch is None:
            return self._rng
        return np.random.default_rng((self._seed, self._epoch, int(idx)))

    def _augment_sample(self, sample: Dict[str, np.ndarray],
                        rng=None) -> Dict[str, np.ndarray]:
        """Flip-H (negate vy) and, in 3D, flip-Z (negate vz), each with p=0.5."""
        if rng is None:
            rng = self._rng
        if rng.random() < 0.5:
            for key in sample:
                if key in ("dxyz", "permeability"):
                    continue
                if sample[key].ndim >= 2:
                    sample[key] = np.flip(sample[key], axis=-2).copy()
            for key in ("velocity", "velocity_input"):
                if key in sample:
                    if self.use_3d:
                        sample[key][:, 1] = -sample[key][:, 1]
                    elif sample[key].ndim == 3 and sample[key].shape[0] >= 2:
                        sample[key][1] = -sample[key][1]
        if self.use_3d and rng.random() < 0.5:
            for key in sample:
                if key in ("dxyz", "permeability"):
                    continue
                if sample[key].ndim >= 4:
                    sample[key] = np.flip(sample[key], axis=0).copy()
            for key in ("velocity", "velocity_input"):
                if key in sample:
                    sample[key][:, 2] = -sample[key][:, 2]
        return sample

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if self.use_3d:
            sample = {
                "microstructure": self.data["microstructure"][idx].astype(np.float32),
                "velocity": self.data["velocity"][idx].astype(np.float32),
                "pressure": self.data["pressure"][idx].astype(np.float32),
                "dxyz": self.data["dxyz"][idx].astype(np.float32),
            }
            if "velocity_input" in self.data:
                sample["velocity_input"] = self.data["velocity_input"][idx].astype(np.float32)
        else:
            sample = {
                "microstructure": self.data["microstructure"][idx].astype(np.float32),
                "velocity": self.data["velocity"][idx, [0, 1]].astype(np.float32),
                "pressure": self.data["pressure"][idx].astype(np.float32),
                "dxyz": self.data["dxyz"][idx].astype(np.float32),
            }
            if "permeability" in self.data:
                sample["permeability"] = self.data["permeability"][idx]
            if "velocity_input" in self.data:
                sample["velocity_input"] = self.data["velocity_input"][idx].astype(np.float32)
        if self.augment:
            sample = self._augment_sample({k: v.copy() for k, v in sample.items()},
                                          rng=self._aug_rng(idx))
        return sample


class MicroFlowDatasetVAE:
    """VAE view: index space doubled to 2N (2D then 3D samples), per-item
    layout (C, D, H, W) (reference VAE_model/utils/dataset.py:286-469)."""

    def __init__(self, root_dir: str, augment: bool = False, seed: int = 0,
                 data: Optional[Dict[str, np.ndarray]] = None):
        base = MicroFlowDataset(root_dir, augment=False, use_3d=True, data=data)
        self.data = base.data
        self.root_dir = root_dir
        self.augment = augment
        self._seed = seed
        self._epoch: Optional[int] = None
        self._rng = np.random.default_rng(seed)

    def set_epoch(self, epoch: int) -> None:
        """(seed, epoch, idx)-derived augmentation for deterministic resume;
        see MicroFlowDataset.set_epoch."""
        self._epoch = int(epoch)

    @property
    def num_microstructures(self) -> int:
        return self.data["microstructure"].shape[0]

    def __len__(self) -> int:
        return 2 * self.num_microstructures

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        n = self.num_microstructures
        is_2d = idx < n
        base_idx = idx if is_2d else idx - n
        key = "velocity_input" if is_2d else "velocity"
        vel = self.data[key][base_idx].astype(np.float32)                 # (D, 3, H, W)
        micro = self.data["microstructure"][base_idx].astype(np.float32)  # (D, 1, H, W)
        pressure = self.data["pressure"][base_idx].astype(np.float32)
        sample = {
            "velocity": np.transpose(vel, (1, 0, 2, 3)),         # (3, D, H, W)
            "microstructure": np.transpose(micro, (1, 0, 2, 3)),  # (1, D, H, W)
            # part of the reference item contract (VAE dataset.py:461-469)
            # even though the final trainers never read them
            "pressure": np.transpose(pressure, (1, 0, 2, 3)),
            "dxyz": self.data["dxyz"][base_idx].astype(np.float32),
            "is_2d": np.asarray(is_2d),
            "original_idx": np.asarray(base_idx),
        }
        if self.augment:
            rng = (self._rng if self._epoch is None else
                   np.random.default_rng((self._seed, self._epoch, int(idx))))
            sample = self._augment_sample(sample, rng=rng)
        return sample

    @staticmethod
    def _augment_sample(sample, rng):
        """Per-axis flips with velocity sign negation, the depth flip negating
        vz (reference VAE dataset.py:439-459). Layout (C, D, H, W)."""
        flips = [(-1, 0), (-2, 1), (-3, 2)]  # (axis, velocity component to negate)
        for axis, comp in flips:
            if rng.random() < 0.5:
                for key in ("velocity", "microstructure", "pressure"):
                    sample[key] = np.flip(sample[key], axis=axis).copy()
                sample["velocity"][comp] = -sample["velocity"][comp]
        return sample


class BlindDataset:
    """Prediction-only dataset (no targets) (reference dataset.py:463-493)."""

    def __init__(self, data: Dict[str, np.ndarray]):
        for key in ("microstructure", "dxyz"):
            if key not in data:
                raise ValueError(f"Missing key `{key}` in data dictionary.")
        self.data = data

    def __len__(self):
        return len(self.data["microstructure"])

    def __getitem__(self, idx):
        return {k: v[idx] for k, v in self.data.items()}


class NumpyLoader:
    """Minimal batched loader over an indexable dataset yielding stacked dicts."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._seed = seed
        self._epoch: Optional[int] = None
        self._rng = np.random.default_rng(seed)

    def set_epoch(self, epoch: int) -> None:
        """Make epoch ``epoch``'s shuffle order (and the wrapped dataset's
        augmentation stream) a pure function of (seed, epoch) instead of the
        stateful default, so a resumed run replays exactly the batches an
        uninterrupted run would have seen (deterministic resume — like
        torch.utils.data.DistributedSampler.set_epoch)."""
        self._epoch = int(epoch)
        set_ds_epoch = getattr(self.dataset, "set_epoch", None)
        if set_ds_epoch is not None:
            set_ds_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = (self._rng if self._epoch is None else
                   np.random.default_rng((self._seed, self._epoch)))
            rng.shuffle(order)
        for i in range(0, len(order), self.batch_size):
            idx = order[i:i + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            samples = [self.dataset[int(j)] for j in idx]
            yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _subset(dataset: MicroFlowDataset, indices: Sequence[int], augment: bool,
            save_stats: bool) -> MicroFlowDataset:
    # dtype pinned: an empty split (tiny datasets) would otherwise produce a
    # float64 index array, which numpy rejects
    idx = np.asarray(indices, dtype=np.int64)
    new_data = {k: v[idx] for k, v in dataset.data.items()}
    return MicroFlowDataset(
        root_dir=dataset.root_dir, augment=augment, use_3d=dataset.use_3d,
        data=new_data, save_stats=save_stats,
    )


def kfold_indices(n: int, k: int, seed: int):
    """(train, test) index arrays of each of ``k`` folds, as scikit-learn's
    ``KFold(k, shuffle=True, random_state=seed).split`` gives them (the JAX
    package's, and the reference's, folds), without scikit-learn: a
    ``RandomState(seed)`` shuffle of 0..n-1 cut into k consecutive folds,
    the first n % k one longer; both index arrays sorted."""
    if not 2 <= k <= n:
        raise ValueError(f"k_folds={k} needs 2 <= k_folds <= {n} samples")
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(k, n // k, dtype=int)
    sizes[: n % k] += 1
    start = 0
    for size in sizes:
        test = np.zeros(n, dtype=bool)
        test[order[start:start + size]] = True
        start += size
        yield np.flatnonzero(~test), np.flatnonzero(test)


def get_loader(
    root_dir: str,
    augment: bool = False,
    train_ratio: float = 0.7,
    val_ratio: float = 0.15,
    test_ratio: float = 0.15,
    batch_size: int = 32,
    shuffle: bool = True,
    seed: int = 2024,
    k_folds: Optional[int] = None,
    use_3d: bool = False,
    split_file: Optional[str] = None,
):
    """70/15/15 split loaders; splits.json wins over regeneration, otherwise
    random.Random(seed) membership identical to the reference
    (dataset.py:561-614). Statistics are written from the training subset."""
    dataset = MicroFlowDataset(root_dir, augment=False, use_3d=use_3d)

    if k_folds is None:
        num_samples = len(dataset)
        split_path = split_file or os.path.join(root_dir, "splits.json")
        if os.path.exists(split_path):
            with open(split_path) as f:
                split_data = json.load(f)
            train_idx = [i for i in split_data["train"] if i < num_samples]
            val_idx = [i for i in split_data["val"] if i < num_samples]
            test_idx = [i for i in split_data["test"] if i < num_samples]
        else:
            indices = list(range(num_samples))
            rng = random.Random(seed)
            rng.shuffle(indices)
            train_size = int(train_ratio * num_samples)
            val_size = int(val_ratio * num_samples)
            train_idx = indices[:train_size]
            val_idx = indices[train_size:train_size + val_size]
            test_idx = indices[train_size + val_size:]

        train_set = _subset(dataset, train_idx, augment=augment, save_stats=True)
        val_set = _subset(dataset, val_idx, augment=False, save_stats=False)
        test_set = _subset(dataset, test_idx, augment=False, save_stats=False)
        return [(
            NumpyLoader(train_set, batch_size, shuffle=shuffle, seed=seed),
            NumpyLoader(val_set, batch_size, shuffle=False),
            NumpyLoader(test_set, batch_size, shuffle=False),
        )]

    out = []
    for train_idx, test_idx in kfold_indices(len(dataset), k_folds, seed):
        train_set = _subset(dataset, train_idx, augment=augment, save_stats=True)
        val_set = _subset(dataset, test_idx, augment=False, save_stats=False)
        train_loader = NumpyLoader(train_set, batch_size, shuffle=shuffle, seed=seed)
        val_loader = NumpyLoader(val_set, batch_size, shuffle=False)
        out.append((train_loader, val_loader, val_loader))
    return out

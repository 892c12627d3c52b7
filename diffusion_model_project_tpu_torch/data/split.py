"""Unified train/val/test split logic (the port's own copy of the JAX
package's ``data/split.py``).

Contract-compatible with the reference shared/data_split.py: same
``random.Random(seed).shuffle`` membership (stdlib, reproducible without
torch), same sorted 70/15/15 index lists, same splits.json schema with the
metadata block, same paired-VAE expansion {i, i+N} and 3D-only filtering.
Default seed 2024 (data_split.py:34).
"""
from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional

DEFAULT_TRAIN_RATIO = 0.70
DEFAULT_VAL_RATIO = 0.15
DEFAULT_TEST_RATIO = 0.15
DEFAULT_SEED = 2024
DEFAULT_SPLIT_FILENAME = "splits.json"


def compute_sample_ids(num_samples: int, id_prefix: str = "sample") -> List[str]:
    return [f"{id_prefix}_{i:06d}" for i in range(num_samples)]


def create_split(
    num_samples: int,
    train_ratio: float = DEFAULT_TRAIN_RATIO,
    val_ratio: float = DEFAULT_VAL_RATIO,
    test_ratio: float = DEFAULT_TEST_RATIO,
    seed: int = DEFAULT_SEED,
    sample_ids: Optional[List[str]] = None,
) -> Dict:
    assert abs(train_ratio + val_ratio + test_ratio - 1.0) < 1e-6

    rng = random.Random(seed)
    shuffled = list(range(num_samples))
    rng.shuffle(shuffled)

    train_size = int(train_ratio * num_samples)
    val_size = int(val_ratio * num_samples)

    train_idx = sorted(shuffled[:train_size])
    val_idx = sorted(shuffled[train_size:train_size + val_size])
    test_idx = sorted(shuffled[train_size + val_size:])

    metadata = {
        "num_samples": num_samples,
        "train_ratio": train_ratio,
        "val_ratio": val_ratio,
        "test_ratio": test_ratio,
        "seed": seed,
    }
    if sample_ids is None:
        return {"train": train_idx, "val": val_idx, "test": test_idx,
                "metadata": {**metadata, "type": "index_based"}}
    assert len(sample_ids) == num_samples
    return {
        "train": [sample_ids[i] for i in train_idx],
        "val": [sample_ids[i] for i in val_idx],
        "test": [sample_ids[i] for i in test_idx],
        "metadata": {**metadata, "type": "id_based"},
    }


def save_split(split: Dict, filepath: str) -> None:
    os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
    with open(filepath, "w") as f:
        json.dump(split, f, indent=2)


def load_split(filepath: str) -> Dict:
    with open(filepath) as f:
        return json.load(f)


def get_or_create_split(
    dataset_dir: str,
    num_samples: int,
    train_ratio: float = DEFAULT_TRAIN_RATIO,
    val_ratio: float = DEFAULT_VAL_RATIO,
    test_ratio: float = DEFAULT_TEST_RATIO,
    seed: int = DEFAULT_SEED,
    split_filename: str = DEFAULT_SPLIT_FILENAME,
    force_recreate: bool = False,
    filter_indices: Optional[List[int]] = None,
) -> Dict:
    """Load splits.json if present (re-creating on size mismatch), else create.

    filter_indices keeps only surviving indices and re-indexes them densely
    (reference data_split.py:202-222).
    """
    split_path = os.path.join(dataset_dir, split_filename)

    if os.path.exists(split_path) and not force_recreate:
        split = load_split(split_path)
        meta = split.get("metadata", {})
        stored_num = meta.get("num_samples", -1)

        if filter_indices is not None:
            filter_set = set(filter_indices)
            split = {k: [i for i in split[k] if i in filter_set]
                     for k in ("train", "val", "test")} | {"metadata": meta}
            old_to_new = {old: new for new, old in enumerate(sorted(filter_indices))}
            split = {k: [old_to_new[i] for i in split[k] if i in old_to_new]
                     for k in ("train", "val", "test")} | {"metadata": meta}
        elif stored_num != num_samples:
            # reference semantics (data_split.py:186-199): a size mismatch
            # regenerates — but loudly, because the old membership is gone
            # and every run trained on it loses its exact split
            print(f"WARNING: {split_path} was built for {stored_num} samples "
                  f"but the dataset now has {num_samples}; regenerating "
                  f"(previous split membership is overwritten)")
            split = create_split(num_samples, train_ratio, val_ratio, test_ratio, seed)
            save_split(split, split_path)
        return split

    effective = len(filter_indices) if filter_indices else num_samples
    split = create_split(effective, train_ratio, val_ratio, test_ratio, seed)
    save_split(split, split_path)
    return split


def create_paired_split_for_vae(
    num_microstructures: int,
    train_ratio: float = DEFAULT_TRAIN_RATIO,
    val_ratio: float = DEFAULT_VAL_RATIO,
    test_ratio: float = DEFAULT_TEST_RATIO,
    seed: int = DEFAULT_SEED,
) -> Dict:
    """Split microstructures, then expand each base index i to {i, i+N} so the
    2D/3D views of one microstructure never straddle splits."""
    base = create_split(num_microstructures, train_ratio, val_ratio, test_ratio, seed)
    n = num_microstructures

    def expand(idx):
        return idx + [i + n for i in idx]

    return {
        "train": expand(base["train"]),
        "val": expand(base["val"]),
        "test": expand(base["test"]),
        "metadata": {**base["metadata"], "type": "paired_vae",
                     "num_microstructures": n},
    }


def get_3d_only_split(paired_split: Dict, num_microstructures: int) -> Dict:
    """Keep only indices >= N (the 3D samples) — stage-1 VAE training."""
    def f(idx):
        return [i for i in idx if i >= num_microstructures]

    return {
        "train": f(paired_split["train"]),
        "val": f(paired_split["val"]),
        "test": f(paired_split["test"]),
        "metadata": {**paired_split.get("metadata", {}), "type": "3d_only_from_paired"},
    }


def main(argv: Optional[List[str]] = None) -> int:
    """CLI for split generation/verification — the reference's
    ``python shared/data_split.py`` surface (data_split.py:401-512):
    --generate writes splits.json (auto-detecting N from x/domain.pt),
    --paired-vae expands to the {i, i+N} paired split, --verify prints an
    existing file's summary. One deviation: the reference declares --force
    but its generate path overwrites unconditionally (data_split.py:453-487);
    here --force is actually required to clobber an existing split file —
    silently regenerating a split invalidates every run trained on it.
    """
    import argparse

    parser = argparse.ArgumentParser(
        description="Generate or verify data splits for VAE and diffusion training")
    parser.add_argument("--dataset-dir", type=str, required=True,
                        help="Path to dataset directory")
    parser.add_argument("--generate", action="store_true",
                        help="Generate new split file")
    parser.add_argument("--verify", action="store_true",
                        help="Verify existing split")
    parser.add_argument("--output", type=str, default=DEFAULT_SPLIT_FILENAME,
                        help=f"Output filename (default: {DEFAULT_SPLIT_FILENAME})")
    parser.add_argument("--train-ratio", type=float, default=DEFAULT_TRAIN_RATIO)
    parser.add_argument("--val-ratio", type=float, default=DEFAULT_VAL_RATIO)
    parser.add_argument("--test-ratio", type=float, default=DEFAULT_TEST_RATIO)
    parser.add_argument("--seed", type=int, default=DEFAULT_SEED)
    parser.add_argument("--num-samples", type=int, default=None,
                        help="Number of samples (auto-detected from x/domain.pt "
                             "if not provided)")
    parser.add_argument("--paired-vae", action="store_true",
                        help="Create paired split for VAE (keeps 2D/3D from the "
                             "same microstructure together)")
    parser.add_argument("--force", action="store_true",
                        help="Force recreate even if split exists")
    args = parser.parse_args(argv)

    if args.generate:
        output_path = os.path.join(args.dataset_dir, args.output)
        if os.path.exists(output_path) and not args.force:
            # refuse BEFORE the (potentially multi-GB) auto-detect load
            print(f"ERROR: {output_path} exists; pass --force to recreate")
            return 1
        if args.num_samples is None:
            domain_path = os.path.join(args.dataset_dir, "x", "domain.pt")
            if not os.path.exists(domain_path):
                raise ValueError("Could not auto-detect num_samples. "
                                 "Please provide --num-samples")
            import torch

            try:  # mmap: only the header is read for .shape[0]
                domain = torch.load(domain_path, map_location="cpu", mmap=True)
            except (RuntimeError, TypeError):  # legacy non-zipfile .pt
                domain = torch.load(domain_path, map_location="cpu")
            args.num_samples = domain.shape[0]
            print(f"Auto-detected {args.num_samples} samples from {domain_path}")
        if args.paired_vae:
            split = create_paired_split_for_vae(
                args.num_samples, args.train_ratio, args.val_ratio,
                args.test_ratio, args.seed)
        else:
            split = create_split(
                args.num_samples, args.train_ratio, args.val_ratio,
                args.test_ratio, args.seed)
        save_split(split, output_path)
        print(f"\nSplit summary:")
        print(f"  Train: {len(split['train'])} samples")
        print(f"  Val: {len(split['val'])} samples")
        print(f"  Test: {len(split['test'])} samples")
        return 0

    if args.verify:
        split_path = os.path.join(args.dataset_dir, args.output)
        if not os.path.exists(split_path):
            print(f"ERROR: Split file not found: {split_path}")
            return 1
        split = load_split(split_path)
        print(f"Split file: {split_path}")
        print(f"  Train: {len(split['train'])} samples")
        print(f"  Val: {len(split['val'])} samples")
        print(f"  Test: {len(split['test'])} samples")
        print(f"  Metadata: {split.get('metadata', {})}")
        return 0

    parser.print_help()
    return 1


def verify_split_consistency(vae_split_path: str, diffusion_split_path: str) -> bool:
    """Check the VAE paired split and the diffusion base split agree at the
    microstructure level (same seed/membership)."""
    vae = load_split(vae_split_path)
    diff = load_split(diffusion_split_path)
    n = vae.get("metadata", {}).get("num_microstructures")
    if n is None:
        n = max(max(vae[k], default=0) for k in ("train", "val", "test")) // 2 + 1
    ok = True
    for k in ("train", "val", "test"):
        vae_base = sorted({i % n for i in vae[k]})
        if vae_base != sorted(diff[k]):
            ok = False
    return ok


if __name__ == "__main__":
    raise SystemExit(main())

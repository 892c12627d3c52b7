"""Generate statistics.json from training indices only: the port's copy of
the root ``scripts/generate_statistics.py`` (reference
shared/generate_statistics.py CLI).

    python -m diffusion_model_project_tpu_torch.scripts.generate_statistics \\
        --dataset-dir DATA --generate-split [--force]
"""
import argparse

from ..data.statistics import generate_statistics


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Compute dataset statistics from training samples only")
    parser.add_argument("--dataset-dir", type=str, required=True)
    parser.add_argument("--output", type=str, default="statistics.json")
    parser.add_argument("--split-file", type=str, default="splits.json")
    parser.add_argument("--use-split", action="store_true",
                        help="Use existing split file")
    parser.add_argument("--generate-split", action="store_true",
                        help="Generate new split file before computing statistics")
    parser.add_argument("--seed", type=int, default=2024)
    parser.add_argument("--train-ratio", type=float, default=0.70)
    parser.add_argument("--val-ratio", type=float, default=0.15)
    parser.add_argument("--force", action="store_true")
    args = parser.parse_args(argv)

    return generate_statistics(
        args.dataset_dir, output=args.output, split_file=args.split_file,
        generate_split=args.generate_split, seed=args.seed,
        train_ratio=args.train_ratio, val_ratio=args.val_ratio, force=args.force)


if __name__ == "__main__":
    main()

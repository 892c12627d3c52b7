"""Diffusion training CLI of the port (the port's copy of the root
``train.py``), flag-compatible with the reference Diffusion_model/train.py:
modes train, CV and optimize (a TPE search, ``study.json`` in ``--save-dir``).

    python -m diffusion_model_project_tpu_torch.train \\
        --root-dir path/to/dataset_3d \\
        --vae-encoder-path trained/stage2 \\
        --vae-decoder-path trained/stage1 \\
        --in-channels 17 --out-channels 8 \\
        --features 64 128 256 512 1024 --attention "3..2" \\
        --batch-size 2 --num-epochs 100

It trains on ``--device`` (default cuda; ``--device cpu`` runs the kernels'
plain versions) and writes the JAX package's run-dir format. SIGTERM or
SIGINT stops within one step, drains the checkpoints and prints the
``--resume`` hint; a second signal kills (``utils/preempt.py``).
"""
from __future__ import annotations

import json
import os.path as osp
import sys

from .data import get_loader
from .training.train_diffusion import find_resumable_run, optimize, train
from .utils.config import parser, process_args, refuse_unported, run_descr
from .utils.preempt import GracefulShutdown


def _loaders(args, k_folds=None):
    """``get_loader`` with the CLI's dataset flags (an optimize trial's
    loader: its batch size is the trial's)."""
    return get_loader(root_dir=args.root_dir, batch_size=args.batch_size,
                      shuffle=args.shuffle, augment=args.augment, k_folds=k_folds,
                      use_3d=args.use_3d)


def run_cv(args, shutdown) -> None:
    """k-fold cross-validation, crash-safe: a fold whose run dir is complete
    (every epoch logged AND its test loss landed) is skipped, an interrupted
    fold resumes full-state, only untouched folds train from scratch. The
    match key holds every hyperparameter of the dirname except the epoch
    budget, so a re-run with a changed config never skips into, or resumes
    from, another config's folds."""
    folds = _loaders(args, k_folds=args.k_folds)
    for i, (train_loader, val_loader, test_loader) in enumerate(folds):
        if shutdown.requested:
            print(f"CV preempted after fold {i}/{args.k_folds}")
            break
        name = f"kfold-{i + 1}.{args.k_folds}"
        args.name = name
        descr = run_descr(process_args(args), with_epochs=False)
        pattern = osp.join(args.save_dir, f"*_{name}_*{descr}*")
        args.resume = None
        # complete by the log alone (a finished run may have deleted its
        # train_state.msgpack), and only once the test loss landed: a kill
        # between the last epoch's checkpoints and the test evaluation
        # resumes instead (no epoch retrains; the test evaluation re-runs)
        done_dir, done = find_resumable_run(pattern, require_state=False)
        if done_dir and done >= args.num_epochs:
            with open(osp.join(done_dir, "log.json")) as f:
                has_test = "test_loss" in json.load(f)
            if has_test:
                print(f"Fold {i + 1}/{args.k_folds} already complete "
                      f"({done} epochs) in {done_dir}; skipping")
                continue
        run_dir, _ = find_resumable_run(pattern)  # state required
        if run_dir:
            print(f"Fold {i + 1}/{args.k_folds} resuming from {run_dir}")
            args.resume = run_dir
        print(f"Cross-Validation [{i + 1}/{args.k_folds}]")
        train(args, train_loader, val_loader, test_loader, should_stop=shutdown)


def main(argv=None) -> None:
    args = parser.parse_args(argv)
    refuse_unported(args)
    if args.debug_nans:
        from .utils.profiling import enable_nan_debugging
        enable_nan_debugging()
    with GracefulShutdown() as shutdown:
        if args.mode == "train":
            train_loader, val_loader, test_loader = _loaders(args)[0]
            train(args, train_loader, val_loader, test_loader, should_stop=shutdown)
        elif args.mode == "CV":
            run_cv(args, shutdown)
        elif args.mode == "optimize":
            optimize(args, _loaders, should_stop=shutdown)


if __name__ == "__main__":
    main(sys.argv[1:])

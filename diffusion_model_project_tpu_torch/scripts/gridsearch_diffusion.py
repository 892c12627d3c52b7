"""Grid search over diffusion hyperparameters (the port's copy of the root
``gridsearch_diffusion.py``, after the reference
Diffusion_model/gridsearch_diffusion.py).

Same contract: a 16-combo grid (4 feature stacks x 4 learning rates, fixed
k=3, attention '3..2', dropout 0, time-emb 64), a dry-run forward pass of
the predictor on random 128x128x11 tensors before each run, a crash-safe
incremental ``results.csv`` with resume by run name, an interrupted run
resumed full-state from its run dir, ``--grid-index`` to run one entry,
``--algo tpe`` (TPE over the same space, rows named by the sampler's seed),
and the ``top10.csv`` + ``summary.txt`` reports, written here with the
standard library (the same rows, in the same order, with the same columns as
the pandas report of the root script).

    python -m diffusion_model_project_tpu_torch.scripts.gridsearch_diffusion \\
        --root-dir DATA --vae-path VAE_DIR --save-dir gridsearch_results \\
        [--grid-index 0] [--algo tpe --n-trials 16] [--device cpu]

It trains on ``--device`` (default cuda).
"""
from __future__ import annotations

import argparse
import csv
import json
import math
import os
import os.path as osp
import time

import numpy as np
import torch

FEATURE_STACKS = ([32, 64, 128, 256], [64, 128, 256, 512],
                  [32, 64, 128, 256, 512], [64, 128, 256, 512, 1024])

GRID = []
for features in FEATURE_STACKS:
    for lr in (1e-3, 5e-4, 1e-4, 5e-5):
        GRID.append({
            "features": features, "learning_rate": lr, "kernel_size": 3,
            "attention": "3..2", "dropout": 0.0, "time_embedding_dim": 64,
        })


def _fixed_cfg(features, learning_rate):
    return {"features": list(features), "learning_rate": float(learning_rate),
            "kernel_size": 3, "attention": "3..2", "dropout": 0.0,
            "time_embedding_dim": 64}


def run_name(cfg: dict) -> str:
    return f"f{len(cfg['features'])}-{cfg['features'][0]}_lr{cfg['learning_rate']:.0e}"


@torch.no_grad()
def dry_run_forward_pass(predictor, num_slices: int = 11, hw: int = 128) -> bool:
    """Smoke-test the whole predictor forward (the frozen encodes and one UNet
    evaluation) on random tensors on the predictor's device before training."""
    r = np.random.default_rng(0)
    dev = predictor.device
    img = torch.from_numpy((r.random((1, num_slices, 1, hw, hw)) > 0.3).astype(np.float32))
    v2d = torch.from_numpy(r.standard_normal((1, num_slices, 3, hw, hw)).astype(np.float32))
    u3d = torch.from_numpy(r.standard_normal((1, num_slices, 3, hw, hw)).astype(np.float32))
    x_start = predictor.encode_target(u3d.to(dev))
    eps_pred, noise, _, _ = predictor.forward(
        img.to(dev), v2d.to(dev), x_start, generator=torch.Generator(dev).manual_seed(0))
    assert eps_pred.shape == noise.shape, (eps_pred.shape, noise.shape)
    return bool(torch.isfinite(eps_pred).all())


def load_completed(results_csv: str) -> set:
    if not osp.exists(results_csv):
        return set()
    with open(results_csv) as f:
        return {row["run_name"] for row in csv.DictReader(f)}


def append_result(results_csv: str, row: dict) -> None:
    exists = osp.exists(results_csv)
    with open(results_csv, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(row))
        if not exists:
            writer.writeheader()
        writer.writerow(row)


def train_single_config(cfg, args, name: str = None) -> dict:
    from ..data import get_loader
    from ..training.helper import set_model
    from ..training.train_diffusion import find_resumable_run, train
    from ..utils.config import parser as train_parser
    from ..utils.config import process_args

    name = name or run_name(cfg)
    argv = [
        "--root-dir", args.root_dir,
        "--save-dir", osp.join(args.save_dir, name),
        "--name", name,
        "--in-channels", str(args.in_channels),
        "--out-channels", str(args.out_channels),
        "--features", *[str(f) for f in cfg["features"]],
        "--kernel-size", str(cfg["kernel_size"]),
        "--attention", cfg["attention"],
        "--dropout", str(cfg["dropout"]),
        "--learning-rate", str(cfg["learning_rate"]),
        "--batch-size", str(args.batch_size),
        "--num-epochs", str(args.epochs),
        "--num-slices", str(args.num_slices),
        "--num-timesteps", str(args.num_timesteps),
        "--padding-mode", "zeros",
        "--shuffle", "true",
        "--device", args.device,
    ]
    if args.vae_encoder_path:
        argv += ["--vae-encoder-path", args.vae_encoder_path]
    if args.vae_decoder_path:
        argv += ["--vae-decoder-path", args.vae_decoder_path]
    if args.vae_path:
        argv += ["--vae-path", args.vae_path]
    targs = train_parser.parse_args(argv)

    # dry-run smoke test before committing to the full run
    pdict = process_args(targs)
    predictor = set_model("latent-diffusion", pdict["training"]["predictor"],
                          osp.join(args.root_dir, "statistics.json"), device=args.device)
    assert dry_run_forward_pass(predictor, num_slices=args.num_slices), \
        "dry-run forward produced non-finite outputs"
    del predictor

    # an interrupted attempt of THIS config left a run dir: resume it
    # full-state instead of retraining
    targs.resume, _ = find_resumable_run(osp.join(args.save_dir, name, "*"))
    if targs.resume:
        print(f"[resume] {name} from {targs.resume}")

    train_loader, val_loader, test_loader = get_loader(
        root_dir=args.root_dir, batch_size=args.batch_size, shuffle=True, use_3d=True)[0]
    t0 = time.time()
    train_loss, val_loss = train(targs, train_loader, val_loader, test_loader)
    return {
        "run_name": name,
        "features": json.dumps(cfg["features"]),
        "learning_rate": cfg["learning_rate"],
        "train_loss": train_loss,
        "val_loss": val_loss,
        "wall_time_s": round(time.time() - t0, 1),
    }


def _number(text: str) -> float:
    """A results.csv cell as the report sorts it: empty or unparsable is NaN."""
    try:
        return float(text)
    except ValueError:
        return math.nan


def _cell(text: str) -> str:
    """A cell as the report writes it: a NaN number is empty, as pandas writes it."""
    return "" if text.strip().lower() in ("nan", "") else text


def _table(header: list, rows: list) -> str:
    """Right-aligned columns, one space apart, as a text table."""
    cols = [[h] + [r[i] for r in rows] for i, h in enumerate(header)]
    widths = [max(len(c) for c in col) for col in cols]
    return "\n".join(" ".join(c.rjust(w) for c, w in zip(line, widths))
                     for line in [header] + rows)


def create_top10_report(results_csv: str, save_dir: str) -> None:
    """top10.csv (the 10 runs of lowest val_loss, ascending, NaN last, all
    columns) and summary.txt (run count, that table, the best config)."""
    with open(results_csv, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [r for r in reader if r]
    col = header.index("val_loss")
    key = lambda r: (math.isnan(_number(r[col])), _number(r[col]))  # noqa: E731
    ranked = sorted(rows, key=key)
    top = [[_cell(c) for c in r] for r in ranked[:10]]
    with open(osp.join(save_dir, "top10.csv"), "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        writer.writerows(top)
    with open(osp.join(save_dir, "summary.txt"), "w") as f:
        f.write(f"Grid search: {len(rows)} completed runs\n\n")
        f.write("Top 10 by validation loss:\n")
        f.write(_table(header, [[c or "NaN" for c in r] for r in top]))
        f.write("\n\nBest config:\n")
        if ranked:
            best = dict(zip(header, ranked[0]))
            f.write(f"  run: {best['run_name']}\n  features: {best['features']}\n")
            f.write(f"  lr: {best['learning_rate']}\n  val_loss: {best['val_loss']}\n")
    print(f"Reports written to {save_dir}/top10.csv and summary.txt")


def _completed_values(results_csv: str) -> dict:
    if not osp.exists(results_csv):
        return {}
    with open(results_csv) as f:
        return {row["run_name"]: float(row["val_loss"]) for row in csv.DictReader(f)}


def run_tpe_search(args, results_csv: str) -> None:
    """TPE over (feature-stack index, log-uniform lr) with crash-safe resume.

    Resume keeps no sampler state: ``suggest(t, history)`` is pure in (seed,
    trial, history), so the loop replays trials 0..t-1, each draw re-derives
    the same params, its run name finds its recorded val_loss in
    results.csv, and the first name missing there is the next trial to run."""
    from ..training.tpe import Dim, TPESampler

    space = [Dim("fidx", 0, len(FEATURE_STACKS) - 1, integer=True),
             Dim("learning_rate", 5e-5, 1e-3, log=True)]
    sampler = TPESampler(space, seed=args.tpe_seed, n_startup_trials=max(2, args.n_trials // 3))
    values = _completed_values(results_csv)
    n_tpe = sum(1 for name in values if name.startswith("tpe"))
    print(f"TPE: {args.n_trials} trials; {n_tpe} tpe rows already in the ledger "
          f"(resume; {len(values) - n_tpe} non-tpe rows ignored)")

    history = []
    for t in range(args.n_trials):
        params = sampler.suggest(t, history)
        cfg = _fixed_cfg(FEATURE_STACKS[int(params["fidx"])], params["learning_rate"])
        # the seed is part of the name: run_name renders lr at one significant
        # digit, so two seeds' searches in one save dir could otherwise collide
        name = f"tpe-s{args.tpe_seed}-{t:02d}-" + run_name(cfg)
        if name in values:
            print(f"[skip] {name} (already in results.csv)")
            history.append((params, values[name]))
            continue
        print(f"[run ] {name}")
        row = train_single_config(cfg, args, name=name)
        append_result(results_csv, row)
        history.append((params, float(row["val_loss"])))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--root-dir", type=str, required=True)
    parser.add_argument("--save-dir", type=str, default="gridsearch_results")
    parser.add_argument("--in-channels", type=int, default=17)
    parser.add_argument("--out-channels", type=int, default=8)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--num-slices", type=int, default=11)
    parser.add_argument("--num-timesteps", type=int, default=1000)
    parser.add_argument("--vae-path", type=str, default=None)
    parser.add_argument("--vae-encoder-path", type=str, default=None)
    parser.add_argument("--vae-decoder-path", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--grid-index", type=int, default=None,
                        help="Run only this grid entry (for sharding across hosts)")
    parser.add_argument("--algo", choices=("grid", "tpe"), default="grid",
                        help="grid = the reference's 16-combo sweep; tpe = TPE "
                             "(training/tpe.py) over the same (feature-stack, log-lr) "
                             "space under the same results.csv resume contract")
    parser.add_argument("--n-trials", type=int, default=16,
                        help="TPE trial budget (--algo tpe; default = the grid's combo count)")
    parser.add_argument("--tpe-seed", type=int, default=2024)
    args = parser.parse_args(argv)

    os.makedirs(args.save_dir, exist_ok=True)
    results_csv = osp.join(args.save_dir, "results.csv")
    completed = load_completed(results_csv)

    if args.algo == "tpe":
        if args.grid_index is not None:
            # TPE is sequential (trial t's draw conditions on trials < t)
            raise SystemExit(
                "--grid-index shards the GRID; --algo tpe is sequential "
                "(each trial conditions on the previous ones) and cannot "
                "be index-sharded — drop one of the flags")
        run_tpe_search(args, results_csv)
        create_top10_report(results_csv, args.save_dir)
        return

    print(f"Grid: {len(GRID)} configs; {len(completed)} already completed (resume)")
    grid = GRID if args.grid_index is None else [GRID[args.grid_index]]
    for cfg in grid:
        name = run_name(cfg)
        if name in completed:
            print(f"[skip] {name} (already in results.csv)")
            continue
        print(f"[run ] {name}")
        row = train_single_config(cfg, args)
        append_result(results_csv, row)

    create_top10_report(results_csv, args.save_dir)


if __name__ == "__main__":
    main()

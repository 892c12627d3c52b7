"""Noise-prediction-loss evaluation over the test split (the port's
counterpart of the root ``evaluate.py``, reference Diffusion_model/evaluate.py).

    python -m diffusion_model_project_tpu_torch.evaluate --model-dir RUN_DIR \
        [--root-dir DATA] [--batch-size N] [--seed S] [--use-ema] [--device cpu]

Loads a run dir's ``log.json`` and weights, evaluates the training criterion
(``training.cost_function``) over the test split, batch by batch, and writes
``test_result.txt`` in the run dir. One ``torch.Generator`` seeded with
``--seed``, on the predictor's device, draws each batch's noise and
timesteps in batch order. Runs on ``cuda`` unless ``--device cpu``.
``run`` returns the losses; ``main`` prints them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import os.path as osp
import sys
import time
from typing import List

import numpy as np
import torch


def get_latest_model_dir(save_dir: str) -> str:
    candidates = [d for d in sorted(os.listdir(save_dir))
                  if osp.isdir(osp.join(save_dir, d))
                  and osp.exists(osp.join(save_dir, d, "log.json"))]
    if not candidates:
        raise FileNotFoundError(f"No model directories with log.json under {save_dir}")
    return osp.join(save_dir, candidates[-1])


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-dir", type=str, default=None,
                        help="Run directory (default: latest under --save-dir)")
    parser.add_argument("--save-dir", type=str, default="./trained/")
    parser.add_argument("--root-dir", type=str, default=None,
                        help="Dataset dir (default: from the run's log.json)")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--seed", type=int, default=2024)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu runs the plain versions)")
    parser.add_argument("--use-ema", action="store_true",
                        help="Prefer ema_model.msgpack (train.py --ema-decay)")
    return parser.parse_args(argv)


@dataclasses.dataclass
class Result:
    cost_name: str
    losses: List[float]             # one a test batch, in batch order
    test_loss: float                # their mean (nan without a batch)
    batch_seconds: List[float]      # each batch's step, host clock, device synchronized
    result_path: str
    predictor: object


def load_predictor(model_dir: str, *, device, use_ema: bool):
    """``predictor_from_directory``, retried with ``time_embedding_dim=None``
    when the load names ``time_mlp``: legacy checkpoints predate time
    embeddings (reference evaluate.py:135-151)."""
    from .utils.checkpoint import predictor_from_directory

    try:
        predictor, _ = predictor_from_directory(model_dir, device=device, use_ema=use_ema)
    except ValueError as e:
        if "time_mlp" not in str(e):
            raise
        print("\nWarning: Model checkpoint missing time embeddings. "
              "Identifying as legacy model.")
        print("Retrying with time_embedding_dim=None...")
        predictor, _ = predictor_from_directory(
            model_dir, device=device, use_ema=use_ema,
            model_kwargs_overrides={"time_embedding_dim": None})
    return predictor


def run(argv=None) -> Result:
    args = parse_args(argv)
    from .data import get_loader
    from .training.helper import select_input_output
    from .training.steps import make_diffusion_eval_step

    model_dir = args.model_dir or get_latest_model_dir(args.save_dir)
    with open(osp.join(model_dir, "log.json")) as f:
        params = json.load(f)["params"]
    root_dir = args.root_dir or params["dataset"]["root_dir"]
    batch_size = args.batch_size or params["dataset"]["batch_size"]
    cost_name = params["training"]["cost_function"]

    _, _, test_loader = get_loader(root_dir=root_dir, batch_size=batch_size,
                                   use_3d=params["dataset"]["use_3d"], seed=args.seed)[0]
    predictor = load_predictor(model_dir, device=args.device, use_ema=args.use_ema)
    eval_step = make_diffusion_eval_step(cost_name=cost_name)
    gen = torch.Generator(device=predictor.device).manual_seed(args.seed)
    losses, seconds = [], []
    for data in test_loader:
        (img, v2d), targets = select_input_output(data)
        t0 = time.perf_counter()
        metrics = eval_step(predictor, {"img": img, "U_2d": v2d, "U": targets}, gen)
        losses.append(float(metrics["val_loss"]))  # waits for the device
        seconds.append(time.perf_counter() - t0)
    avg = float(np.mean(losses)) if losses else float("nan")

    result_path = osp.join(model_dir, "test_result.txt")
    with open(result_path, "w") as f:
        f.write(f"cost_function: {cost_name}\n")
        f.write(f"test_loss: {avg}\n")
        f.write(f"num_batches: {len(losses)}\n")
    return Result(cost_name, losses, avg, seconds, result_path, predictor)


def main(argv=None):
    res = run(argv)
    print(f"Test loss ({res.cost_name}): {res.test_loss}")
    print(f"Wrote {res.result_path}")


if __name__ == "__main__":
    main(sys.argv[1:])

"""End-to-end inference CLI of the port (counterpart of the root
``inference.py``).

    python -m diffusion_model_project_tpu_torch.inference --model-dir RUN_DIR \
        [--sampler ddpm|ddim|dpm] [--steps N] [--index I | --input-file F] [--device cpu]

Loads a diffusion run dir (``log.json`` + weights: native msgpack or
reference ``.pt``, with the VAE it names), takes sample ``--index`` of the
test split of the dataset (or a user ``.pt``/``.npz`` file), predicts the 3D
velocity with DDPM (the default, T steps), DDIM or DPM-Solver++ from a
``torch.Generator`` seeded with ``seed + index``, and writes a matplotlib
comparison PNG (napari 3D viewing where installed). Runs on ``cuda`` unless
``--device cpu``. ``run`` returns the prediction before any plotting.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os.path as osp
import sys
import time
from typing import Optional

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-dir", type=str, required=True,
                        help="Trained diffusion run directory (log.json + weights)")
    parser.add_argument("--root-dir", type=str, default=None,
                        help="Dataset dir (default: from log.json)")
    parser.add_argument("--vae-path", type=str, default=None)
    parser.add_argument("--vae-encoder-path", type=str, default=None)
    parser.add_argument("--vae-decoder-path", type=str, default=None)
    parser.add_argument("--index", type=int, default=0,
                        help="Test-split sample index")
    parser.add_argument("--input-file", type=str, default=None,
                        help="Optional .pt/.npz file with microstructure + velocity_input")
    parser.add_argument("--sampler", type=str, default="ddpm",
                        choices=["ddpm", "ddim", "dpm"])
    parser.add_argument("--steps", type=int, default=50, help="DDIM / DPM steps")
    parser.add_argument("--seed", type=int, default=2024)
    parser.add_argument("--output", type=str, default=None,
                        help="Output PNG path (default: <model-dir>/prediction_<idx>.png)")
    parser.add_argument("--napari", action="store_true",
                        help="Open interactive napari 3D viewer if installed")
    parser.add_argument("--slice", dest="slice_idx", type=int, default=None,
                        help="z-slice to plot (default: middle)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu runs the plain versions)")
    parser.add_argument("--use-ema", action="store_true",
                        help="Prefer ema_model.msgpack (train.py --ema-decay)")
    return parser.parse_args(argv)


def load_sample(args, params):
    """(img, velocity_2d, target or None), each with a leading batch of 1."""
    if args.input_file:
        if args.input_file.endswith(".npz"):
            data = dict(np.load(args.input_file))
        else:
            raw = torch.load(args.input_file, map_location="cpu", weights_only=False)
            data = {k: np.asarray(v) for k, v in raw.items()}
        img = data["microstructure"].astype(np.float32)
        v2d = data["velocity_input"].astype(np.float32)
        target = data.get("velocity")
        return img[None], v2d[None], None if target is None else target[None].astype(np.float32)

    from .data import get_loader

    root_dir = args.root_dir or params["dataset"]["root_dir"]
    _, _, test_loader = get_loader(root_dir=root_dir, batch_size=1,
                                   use_3d=True, seed=args.seed)[0]
    data = test_loader.dataset[args.index]
    return (data["microstructure"][None], data["velocity_input"][None],
            data["velocity"][None])


@dataclasses.dataclass
class Result:
    prediction: np.ndarray          # (1, S, 3, H, W), masked
    target: Optional[np.ndarray]    # the sample's 3D velocity, where it has one
    img: np.ndarray                 # (1, S, 1, H, W) microstructure
    predictor: object               # the LatentDiffusionPredictor that ran
    seconds: float                  # the sampler call, host clock, device synchronized
    args: argparse.Namespace


def run(argv=None) -> Result:
    """Parse ``argv``, load the run dir and the sample, and predict."""
    args = parse_args(argv)
    if bool(args.vae_encoder_path) != bool(args.vae_decoder_path):
        raise SystemExit(
            "--vae-encoder-path and --vae-decoder-path must be given "
            "together (one alone would be silently ignored and the model "
            "dir's logged VAE paths used instead)")
    from .utils.checkpoint import predictor_from_directory

    with open(osp.join(args.model_dir, "log.json")) as f:
        params = json.load(f)["params"]
    overrides = None
    if args.vae_path or (args.vae_encoder_path and args.vae_decoder_path):
        overrides = {"vae_path": args.vae_path,
                     "vae_encoder_path": args.vae_encoder_path,
                     "vae_decoder_path": args.vae_decoder_path}

    img, v2d, target = load_sample(args, params)
    predictor, _ = predictor_from_directory(
        args.model_dir, device=args.device, vae_path_overrides=overrides,
        use_ema=args.use_ema)

    dev = predictor.device
    gen = torch.Generator(device=dev).manual_seed(args.seed + args.index)
    img_t, v2d_t = torch.from_numpy(img).to(dev), torch.from_numpy(v2d).to(dev)
    t0 = time.perf_counter()
    if args.sampler == "ddim":
        out = predictor.predict_ddim(img_t, v2d_t, num_steps=args.steps, eta=0.0, generator=gen)
    elif args.sampler == "dpm":
        out = predictor.predict_dpm(img_t, v2d_t, num_steps=args.steps, generator=gen)
    else:
        out = predictor.predict(img_t, v2d_t, generator=gen)
    prediction = out.cpu().numpy()  # waits for the device
    return Result(prediction, target, img, predictor, time.perf_counter() - t0, args)


def plot_comparison(prediction, target, img, out_path, slice_idx=None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    s = prediction.shape[1]
    k = slice_idx if slice_idx is not None else s // 2
    names = ["vx", "vy", "vz"]
    rows = 3 if target is not None else 2
    fig, axes = plt.subplots(rows, 3, figsize=(12, 3.5 * rows))
    for c in range(3):
        vmax = np.abs(prediction[0, k, c]).max() or 1.0
        axes[0, c].imshow(prediction[0, k, c], cmap="RdBu_r", vmin=-vmax, vmax=vmax)
        axes[0, c].set_title(f"pred {names[c]} (slice {k})")
        if target is not None:
            tmax = np.abs(target[0, k, c]).max() or 1.0
            axes[1, c].imshow(target[0, k, c], cmap="RdBu_r", vmin=-tmax, vmax=tmax)
            axes[1, c].set_title(f"target {names[c]}")
            err = np.abs(prediction[0, k, c] - target[0, k, c])
            axes[2, c].imshow(err, cmap="magma")
            axes[2, c].set_title(f"|error| {names[c]}")
        else:
            axes[1, c].imshow(img[0, k, 0], cmap="gray")
            axes[1, c].set_title("microstructure")
    for ax in axes.ravel():
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    print(f"Wrote {out_path}")


def show_napari(prediction, img):
    try:
        import napari
    except ImportError:
        print("napari not installed; skipping 3D viewer")
        return
    mag = np.linalg.norm(prediction[0], axis=1)
    p99 = np.percentile(np.abs(mag), 99) or 1.0
    viewer = napari.Viewer()
    viewer.add_image(mag / p99, name="velocity magnitude", scale=(50.0, 5.0, 5.0))
    viewer.add_image(img[0, :, 0], name="microstructure", scale=(50.0, 5.0, 5.0))
    napari.run()


def main(argv=None):
    res = run(argv)
    args = res.args
    print(f"{args.sampler} on {res.predictor.device}: {res.seconds:.2f} s")
    out_path = args.output or osp.join(args.model_dir, f"prediction_{args.index}.png")
    plot_comparison(res.prediction, res.target, res.img, out_path, args.slice_idx)
    if args.napari:
        show_napari(res.prediction, res.img)


if __name__ == "__main__":
    main(sys.argv[1:])

"""VAE inference and visualization CLI of the port (counterpart of the root
``inference_vae.py``, reference VAE_model/inference_vae.py).

    python -m diffusion_model_project_tpu_torch.inference_vae --vae-path VAE_DIR \
        --dataset-dir DATA [--mode 2d|3d|cross] [--index I] [--device cpu]

Loads a VAE checkpoint dir (native msgpack or reference ``.pt``; the model
type detected from the state dict's prefixes), encodes and decodes one
microstructure of the VAE dataset (``MicroFlowDatasetVAE``) in one of three
modes, '2d' (E2D -> D2D), '3d' (E3D -> D3D) or 'cross' (E2D -> D3D), prints
the fluid-masked per-component MAE and writes three PNG panels: original /
reconstruction / error, the latent channels, and the w component slice by
slice. Runs on ``cuda`` unless ``--device cpu``. ``run`` returns the metrics
and tensors before any plotting; ``main`` plots.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os.path as osp
import sys
import time

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="VAE inference and visualization")
    parser.add_argument("--vae-path", type=str, required=True,
                        help="Checkpoint dir (native msgpack or reference .pt)")
    parser.add_argument("--dataset-dir", type=str, required=True)
    parser.add_argument("--mode", type=str, default="3d", choices=["2d", "3d", "cross"])
    parser.add_argument("--index", type=int, default=0,
                        help="Microstructure index")
    parser.add_argument("--latent-channels", type=int, default=None,
                        help="Override latent channels (default from vae_log.json)")
    parser.add_argument("--output-dir", type=str, default=None,
                        help="Where to write PNGs (default: vae-path)")
    parser.add_argument("--slice", dest="slice_idx", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu runs the plain versions)")
    return parser.parse_args(argv)


def detect_model_type(vae_path: str) -> str:
    """Checkpoint flavour from the branches it holds (reference
    inference_vae.py:128-175)."""
    from .utils import torch_import as ti
    from .utils.checkpoint import _load_native_branches

    native = _load_native_branches(vae_path)
    if native is not None:
        has_2d = "encoder_2d" in native
        has_3d = "encoder_3d" in native
        if has_2d and has_3d:
            return "dual_full"
        if has_3d:
            return "dual_stage1_3d_only"
        return "dual_stage2"
    sd = ti.load_torch_state_dict(ti.find_model_file(vae_path))
    return {
        "dual_full": "dual_full", "dual_stage1_3d": "dual_stage1_3d_only",
        "dual_stage2_2d": "dual_stage2", "standard": "standard", None: "unknown",
    }[ti.detect_vae_checkpoint_type(sd)]


def load_vae(vae_path: str, latent_channels=None, device="cuda"):
    """A frozen ``DualBranchVAE`` with the dir's weights (strict) on
    ``device``; returns ``(vae, norm_factors, flavor)``."""
    from .models.vae import DualBranchVAE, features_from_decoder_state
    from .utils.checkpoint import _vae_state_dict, load_dual_vae_from_paths, load_strict
    from .utils.device import resolve_device

    device = resolve_device(device)
    log_path = osp.join(vae_path, "vae_log.json")
    if latent_channels is None and osp.exists(log_path):
        with open(log_path) as f:
            latent_channels = json.load(f).get("latent_channels", 8)
    latent_channels = latent_channels or 8
    branches, norm_factors, flavor = load_dual_vae_from_paths(vae_path=vae_path)
    with device:
        # conditional standard checkpoints (FiLM) take the reference's
        # per-branch condition constants (see DualBranchVAE.conditional)
        vae = DualBranchVAE(latent_channels=latent_channels,
                            features=features_from_decoder_state(branches["decoder_3d"]),
                            conditional=flavor == "standard_conditional")
    load_strict(vae, _vae_state_dict(branches), f"VAE ({flavor}) from {vae_path}")
    return vae.requires_grad_(False).eval(), norm_factors, flavor


@torch.inference_mode()
def encode_decode(vae, mode: str, v2d: torch.Tensor, v3d: torch.Tensor):
    """Dispatch (reference inference_vae.py:518-561). Inputs channels-first
    (B, 3, D, H, W); returns (recon, mu, source)."""
    if mode == "2d":
        mu, _ = vae.encode_2d_deterministic(v2d)
        return vae.decode_2d(mu), mu, v2d
    if mode == "3d":
        mu, _ = vae.encode_3d_deterministic(v3d)
        return vae.decode_3d(mu), mu, v3d
    if mode == "cross":
        mu, _ = vae.encode_2d_deterministic(v2d)
        return vae.decode_3d(mu), mu, v3d
    raise ValueError(mode)


def masked_mae_per_component(recon, target, mask):
    """Fluid-masked per-component MAE (reference inference_vae.py:472-515);
    channels-first (B, 3, D, H, W) arrays, mask (B, 1, D, H, W)."""
    out = {}
    m = mask[:, 0]
    n = m.sum() + 1e-8
    for c, name in enumerate("uvw"):
        out[f"mae_{name}"] = float((np.abs(recon[:, c] - target[:, c]) * m).sum() / n)
    out["mae_total"] = float(np.mean([out[f"mae_{n}"] for n in "uvw"]))
    return out


@dataclasses.dataclass
class Result:
    metrics: dict
    recon: np.ndarray       # (1, 3, D, H, W), masked
    target: np.ndarray      # (1, 3, D, H, W), masked
    mu: np.ndarray          # (1, latent, ld, H/4, W/4)
    model_type: str
    flavor: str
    seconds: float          # encode + decode, host clock, device synchronized
    args: argparse.Namespace


def run(argv=None) -> Result:
    """Parse ``argv``, load the VAE and the sample, encode and decode."""
    args = parse_args(argv)
    from .data import MicroFlowDatasetVAE

    model_type = detect_model_type(args.vae_path)
    print(f"Detected model type: {model_type}")
    if model_type == "dual_stage2" and args.mode != "2d":
        print("NOTE: stage-2 checkpoint has no 3D branch; forcing mode '2d'")
        args.mode = "2d"
    if model_type == "dual_stage1_3d_only" and args.mode != "3d":
        print("NOTE: stage-1 checkpoint shares E3D for both branches")

    vae, norm_factors, flavor = load_vae(args.vae_path, args.latent_channels, args.device)
    nf = np.asarray(norm_factors or [1.0, 1.0, 1.0], np.float32)
    print(f"Normalization factors: {nf.tolist()}")

    ds = MicroFlowDatasetVAE(args.dataset_dir)
    n = ds.num_microstructures
    s2d = ds[args.index]
    s3d = ds[args.index + n]
    dev = next(vae.parameters()).device
    scale = nf.reshape(3, 1, 1, 1)
    v2d = torch.from_numpy(s2d["velocity"] / scale)[None].to(dev)
    v3d = torch.from_numpy(s3d["velocity"] / scale)[None].to(dev)
    mask = (s3d if args.mode != "2d" else s2d)["microstructure"][None]

    t0 = time.perf_counter()
    recon, mu, target = encode_decode(vae, args.mode, v2d, v3d)
    recon, mu, target = (t.float().cpu().numpy() for t in (recon, mu, target))
    seconds = time.perf_counter() - t0
    recon = recon * mask
    target = target * mask

    metrics = masked_mae_per_component(recon, target, mask)
    print(f"Masked per-component MAE ({args.mode}): "
          + ", ".join(f"{k}={v:.6f}" for k, v in metrics.items()))
    return Result(metrics, recon, target, mu, model_type, flavor, seconds, args)


def plot_triptych(recon, target, out_path, slice_idx):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    k = slice_idx
    fig, axes = plt.subplots(3, 3, figsize=(12, 11))
    for c, name in enumerate(["vx", "vy", "vz"]):
        vmax = max(np.abs(target[0, c, k]).max(), 1e-8)
        axes[0, c].imshow(target[0, c, k], cmap="RdBu_r", vmin=-vmax, vmax=vmax)
        axes[0, c].set_title(f"original {name}")
        axes[1, c].imshow(recon[0, c, k], cmap="RdBu_r", vmin=-vmax, vmax=vmax)
        axes[1, c].set_title(f"reconstruction {name}")
        axes[2, c].imshow(np.abs(recon[0, c, k] - target[0, c, k]), cmap="magma")
        axes[2, c].set_title(f"|error| {name}")
    for ax in axes.ravel():
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_latent_grid(mu, out_path, slice_idx):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    c = mu.shape[1]
    cols = min(c, 4)
    rows = (c + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows), squeeze=False)
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        if i < c:
            ax.imshow(mu[0, i, slice_idx], cmap="viridis")
            ax.set_title(f"latent ch {i}", fontsize=8)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_w_depth_strip(recon, target, out_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = recon.shape[2]
    fig, axes = plt.subplots(2, d, figsize=(1.6 * d, 3.6), squeeze=False)
    vmax = max(np.abs(target[0, 2]).max(), 1e-8)
    for k in range(d):
        axes[0][k].imshow(target[0, 2, k], cmap="RdBu_r", vmin=-vmax, vmax=vmax)
        axes[1][k].imshow(recon[0, 2, k], cmap="RdBu_r", vmin=-vmax, vmax=vmax)
        axes[0][k].axis("off")
        axes[1][k].axis("off")
        axes[0][k].set_title(f"z={k}", fontsize=7)
    axes[0][0].set_ylabel("target w")
    axes[1][0].set_ylabel("recon w")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def main(argv=None):
    res = run(argv)
    args = res.args
    out_dir = args.output_dir or args.vae_path
    k = args.slice_idx if args.slice_idx is not None else res.recon.shape[2] // 2
    stem = f"vae_{args.mode}_{{}}_{args.index}.png"
    plot_triptych(res.recon, res.target, osp.join(out_dir, stem.format("triptych")), k)
    plot_latent_grid(res.mu, osp.join(out_dir, stem.format("latent")), k)
    plot_w_depth_strip(res.recon, res.target, osp.join(out_dir, stem.format("wstrip")))
    print(f"Wrote visualization PNGs to {out_dir}")
    return res.metrics


if __name__ == "__main__":
    main(sys.argv[1:])

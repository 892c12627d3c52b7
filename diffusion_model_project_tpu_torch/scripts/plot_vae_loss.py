"""Plot VAE loss curves from vae_log.json, handling stage-1 and stage-2
log formats (reference VAE_model/plot_vae_loss.py; the port's copy of the root
``scripts/plot_vae_loss.py``: host-side matplotlib, no device)."""
import argparse
import json
import os.path as osp


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-dir", type=str, required=True)
    parser.add_argument("--output", type=str, default=None)
    args = parser.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(osp.join(args.model_dir, "vae_log.json")) as f:
        log = json.load(f)
    loss = log["loss"]

    if "recons_2d_train" in loss:  # stage-2 format
        panels = [("recons_2d", "2D reconstruction"), ("align", "Alignment"),
                  ("cross", "Cross-reconstruction"), ("kl_2d", "KL (2D)")]
    else:  # stage-1 / standard format
        panels = [("recons", "Reconstruction"), ("kl", "KL divergence")]

    n = len(panels)
    fig, axes = plt.subplots(1, n, figsize=(4.5 * n, 4))
    if n == 1:
        axes = [axes]
    for ax, (key, title) in zip(axes, panels):
        tr = loss.get(f"{key}_train", [])
        va = loss.get(f"{key}_val", [])
        if tr:
            ax.plot(tr, label="train")
        if va:
            ax.plot(va, label="val")
        ax.set_title(title)
        ax.set_xlabel("epoch")
        ax.legend()
        ax.grid(alpha=0.3)
    out = args.output or osp.join(args.model_dir, "vae_loss.png")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print(f"Wrote {out}")


if __name__ == "__main__":
    main()

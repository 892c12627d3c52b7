"""Plot train/val loss curves from a run dir's log.json
(reference Diffusion_model/scripts/plot_loss.py; the port's copy of the root
``scripts/plot_loss.py``: host-side matplotlib, no device)."""
import argparse
import json
import os.path as osp


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-dir", type=str, required=True,
                        help="Run directory containing log.json")
    parser.add_argument("--output", type=str, default=None,
                        help="Output PNG (default <model-dir>/loss.png)")
    parser.add_argument("--log-scale", action="store_true")
    args = parser.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(osp.join(args.model_dir, "log.json")) as f:
        log = json.load(f)

    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(log["epoch"], log["train_loss"], label="train")
    ax.plot(log["epoch"], log["val_loss"], label="val")
    if "test_loss" in log:
        ax.axhline(log["test_loss"], ls="--", c="gray",
                   label=f"test={log['test_loss']:.4f}")
    if args.log_scale:
        ax.set_yscale("log")
    ax.set_xlabel("epoch")
    ax.set_ylabel(log["params"]["training"]["cost_function"])
    ax.legend()
    ax.grid(alpha=0.3)
    out = args.output or osp.join(args.model_dir, "loss.png")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print(f"Wrote {out}")


if __name__ == "__main__":
    main()

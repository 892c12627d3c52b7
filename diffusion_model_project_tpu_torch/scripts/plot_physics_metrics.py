"""Plot physics-metric panels from run dirs' log.json, with multi-run compare
(reference Diffusion_model/scripts/plot_physics_metrics.py; the port's copy of the root
``scripts/plot_physics_metrics.py``: host-side matplotlib, no device)."""
import argparse
import json
import os.path as osp

PANELS = [
    ("div_mean", "Mean |divergence| (fluid)"),
    ("flow_rate_cv", "Flow-rate CV"),
    ("gradient_smooth", "Gradient smoothness"),
    ("laplacian_smooth", "Laplacian smoothness"),
]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-dirs", type=str, nargs="+", required=True,
                        help="One or more run directories to compare")
    parser.add_argument("--output", type=str, default="physics_metrics.png")
    args = parser.parse_args(argv)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(11, 8))
    for model_dir in args.model_dirs:
        with open(osp.join(model_dir, "log.json")) as f:
            log = json.load(f)
        label = osp.basename(osp.normpath(model_dir))
        pm = log.get("physics_metrics", {})
        for ax, (key, title) in zip(axes.ravel(), PANELS):
            series = pm.get(key, [])
            if series:
                ax.plot(log["epoch"][: len(series)], series, label=label)
            ax.set_title(title)
            ax.set_xlabel("epoch")
            ax.grid(alpha=0.3)
    axes[0, 0].legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(args.output, dpi=120)
    print(f"Wrote {args.output}")


if __name__ == "__main__":
    main()

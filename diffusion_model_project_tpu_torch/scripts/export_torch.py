"""Export native run-dir checkpoints to the reference's .pt format (the
port's copy of the root ``scripts/export_torch.py``).

Run dirs trained by either package convert in place (or to --out-dir) into
directories the reference's torch loaders, and the port's ``.pt`` loaders,
read with ``strict=True``: diffusion runs (``log.json``) and stage-1 /
stage-2 VAE runs (``vae_log.json``).

    python -m diffusion_model_project_tpu_torch.scripts.export_torch RUN_DIR \\
        [--kind auto|diffusion|vae] [--out-dir DIR]
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

from ..utils.torch_export import export_diffusion_dir, export_vae_dir


def detect_kind(run_dir: str) -> str:
    if osp.exists(osp.join(run_dir, "log.json")):
        return "diffusion"
    if osp.exists(osp.join(run_dir, "vae_log.json")):
        return "vae"
    raise SystemExit(
        f"{run_dir}: neither log.json (diffusion run) nor vae_log.json "
        f"(VAE run) found; pass --kind explicitly.")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("run_dir", help="native run directory (msgpack checkpoints)")
    p.add_argument("--kind", choices=("auto", "diffusion", "vae"), default="auto")
    p.add_argument("--out-dir", default=None,
                   help="write .pt files here instead of into run_dir")
    args = p.parse_args(argv)

    kind = detect_kind(args.run_dir) if args.kind == "auto" else args.kind
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    if kind == "diffusion":
        written = export_diffusion_dir(args.run_dir, args.out_dir)
    else:
        written = export_vae_dir(args.run_dir, args.out_dir)
    for path in written:
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

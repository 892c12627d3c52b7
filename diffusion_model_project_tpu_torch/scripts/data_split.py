"""Generate or verify splits.json: the port's copy of the root
``scripts/data_split.py`` (the reference's ``python shared/data_split.py``
CLI, data_split.py:401-512). The logic lives in ``data/split.py``.

    python -m diffusion_model_project_tpu_torch.scripts.data_split \\
        --dataset-dir DATA --generate [--paired-vae] [--force] | --verify
"""
from ..data.split import main

if __name__ == "__main__":
    raise SystemExit(main())

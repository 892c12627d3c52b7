"""Stage-1 VAE training CLI of the port (the port's copy of the root
``train_3d_vae_only.py``, after the reference VAE_model/train_3d_vae_only.py):
E3D + D3D on the dataset's 3D velocity fields.

    python -m diffusion_model_project_tpu_torch.train_3d_vae_only \\
        --dataset-dir path/to/dataset_3d --save-dir trained/stage1

It trains on ``--device`` (default cuda) and writes the JAX package's VAE
run-dir format (``training/train_vae_stage1.py``).
"""
from .training.train_vae_stage1 import main

if __name__ == "__main__":
    main()

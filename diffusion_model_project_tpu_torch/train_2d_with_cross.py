"""Stage-2 VAE training CLI of the port (the port's copy of the root
``train_2d_with_cross.py``, after the reference
VAE_model/train_2d_with_cross.py): E2D + D2D against the frozen stage-1
E3D / D3D, with the alignment and cross-reconstruction losses.

    python -m diffusion_model_project_tpu_torch.train_2d_with_cross \\
        --dataset-dir path/to/dataset_3d --stage1-checkpoint trained/stage1 \\
        --save-dir trained/stage2 --lambda-align 5 --lambda-cross 50

It trains on ``--device`` (default cuda) and writes the JAX package's VAE
run-dir format (``training/train_vae_stage2.py``).
"""
from .training.train_vae_stage2 import main

if __name__ == "__main__":
    main()

"""Standalone VAE argparse surface (the port's own copy of the JAX package's
``utils/vae_config.py``; reference VAE_model/config/vae.py:6-94).

The two stage trainers carry their own (richer) parsers; this module keeps
the reference's shared VAE parser contract for external users: defaults
in 3 / latent 8 / k 3 / batch 1 / epochs 100 / lr 1e-6, per-component
normalization on by default, conditional mode and vz weighting flags.
Building the parser parses nothing; callers call ``parser.parse_args``.
"""
import argparse

parser = argparse.ArgumentParser()

parser.add_argument("--dataset-dir", type=str, default="../dataset_3d",
                    help="Directory for dataset.")
parser.add_argument("--save-dir", type=str, default="trained/vae",
                    help="Directory where to save results.")
parser.add_argument("--in-channels", type=int, default=3,
                    help="Number of channels in input data (vx, vy, vz).")
parser.add_argument("--latent-channels", type=int, default=8,
                    help="Number of channels in latent space.")
parser.add_argument("--kernel-size", type=int, default=3,
                    help="Kernel size for convolutional layers.")
parser.add_argument("--batch-size", type=int, default=1,
                    help="Batch size (reduced to 1 for 3D Conv memory management).")
parser.add_argument("--num-epochs", type=int, default=100, help="Number of epochs.")
parser.add_argument("--augment", action="store_true", default=False,
                    help="Whether to use data augmentation.")
parser.add_argument("--device", type=str, default=None,
                    help="Device (e.g., cpu, cuda) on which to train the network.")
parser.add_argument("--learning-rate", type=float, default=1e-6, help="Learning rate.")
parser.add_argument("--no-per-component-norm", dest="per_component_norm",
                    action="store_false", default=True,
                    help="Disable per-component normalization (legacy global max).")
parser.add_argument("--conditional", action="store_true", default=False,
                    help="Enable conditional VAE mode (is_3d FiLM conditioning).")
parser.add_argument("--vz-weight", type=float, default=1.0,
                    help="Loss weight multiplier for the w (vz) component.")

"""The training side of the port (the JAX package's ``training/``): the
diffusion train and validation steps (``steps.py``), the epoch loop and
model setup (``helper.py``) and the trainer (``train_diffusion.py``); the VAE
trainers (``train_vae_stage1.py``, ``train_vae_stage2.py``) with the
reference's clipped gradient accumulation (``accum.py``)."""

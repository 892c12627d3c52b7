"""The diffusion training side of the port (the JAX package's ``training/``):
the train and validation steps (``steps.py``), the epoch loop and model
setup (``helper.py``) and the driver (``train_diffusion.py``)."""

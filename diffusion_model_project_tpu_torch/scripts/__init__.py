"""Command-line probes of the port (``python -m diffusion_model_project_tpu_torch.scripts.<name>``)."""

"""Published model configuration (the port's own copy of the JAX package's
``utils/config.py::PUBLISHED_UNET_KWARGS``)."""
from __future__ import annotations

# UNet of the published checkpoint: in 17 (latent 8 + E2D latent 8 + mask 1),
# out 8, five levels 64..1024, 2-head attention from level 3 down.
PUBLISHED_UNET_KWARGS = dict(
    in_channels=17, out_channels=8, features=(64, 128, 256, 512, 1024),
    kernel_size=3, padding_mode="zeros", activation="silu",
    final_activation=None, attention="3..2", dropout=0.0,
    time_embedding_dim=64,
)
PUBLISHED_LATENT_CHANNELS = 8

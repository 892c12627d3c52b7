"""Datasets and loaders (the port's own copies of the JAX package's ``data/``)."""
from .dataset import BlindDataset, MicroFlowDataset, MicroFlowDatasetVAE, NumpyLoader, get_loader

__all__ = ["BlindDataset", "MicroFlowDataset", "MicroFlowDatasetVAE", "NumpyLoader",
           "get_loader"]

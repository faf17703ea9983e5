"""The synthetic data pipeline (the port of the JAX package's ``data``)."""

from .pipeline import DataConfig, SyntheticDataset, make_global_batch  # noqa: F401

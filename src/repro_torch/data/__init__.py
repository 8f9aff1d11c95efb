"""Synthetic data of the port (``repro.data``)."""
from .synthetic import BigramLM, synthetic_features, synthetic_mnist  # noqa: F401

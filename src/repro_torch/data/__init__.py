"""Synthetic data of the port (``repro.data``)."""
from .synthetic import BigramLM  # noqa: F401

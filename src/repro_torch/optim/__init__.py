"""Optimizers of the port (``repro.optim``): AdamW written by hand."""
from .adam import AdamWConfig  # noqa: F401

"""The training engine of the port (``repro.train``)."""
from .trainer import Trainer, TrainerConfig  # noqa: F401

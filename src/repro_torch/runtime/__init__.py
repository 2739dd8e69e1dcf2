"""Serving and training runtime of the port."""

from repro_torch.runtime.server import Server, ServerConfig  # noqa: F401
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: F401

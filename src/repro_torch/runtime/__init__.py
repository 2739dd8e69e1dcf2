"""Serving runtime of the port."""

from repro_torch.runtime.server import Server, ServerConfig  # noqa: F401

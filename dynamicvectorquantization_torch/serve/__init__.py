"""Serving: the dynamic-batching sampler."""
from .server import BatchingSampler

__all__ = ["BatchingSampler"]

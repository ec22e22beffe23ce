"""Serving: the dynamic-batching sampler and its HTTP front end
(`python -m dynamicvectorquantization_torch.serve`, `serve/http.py`)."""
from .server import BatchingSampler

__all__ = ["BatchingSampler"]

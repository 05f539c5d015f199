"""Small constant tables on the working device, built once per process.

`torch.tensor(values, device="cuda")` copies from host memory and makes the
host wait for the card; the tables here are made from fills, which carry
their value in the launch, and are cached per device, so no frame pays for
them and no host sync happens. Callers must not write to them.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def table(values: tuple, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    """torch.tensor(values, dtype=dtype) on `device`, built without a
    host-to-device copy."""
    if torch.device(device).type == "cpu":
        return torch.tensor(values, dtype=dtype)
    return torch.stack([torch.full((), v, dtype=dtype, device=device)
                        for v in values])

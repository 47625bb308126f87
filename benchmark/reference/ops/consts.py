"""Host constants as device tensors, made once per device.

Making a CUDA tensor from host data (``torch.tensor``, ``as_tensor``, an
index written as a Python list, a number written into an element) copies
from pageable memory, and that copy waits for the stream. A frame that
did so would wait for the frame before it. ``device_constant`` makes such
a tensor on its first use, during a warm-up frame, and every later frame
reuses it.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """torch.tensor(values, dtype=dtype, device=device), made once per
    (values, dtype, device). values is a (nested) tuple of numbers. The
    tensor is shared by every caller: never write into it."""
    return torch.tensor(values, dtype=dtype, device=device)

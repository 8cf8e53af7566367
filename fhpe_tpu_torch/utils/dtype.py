"""Compute-dtype resolution for the serving Predictor.

``TPU.COMPUTE_DTYPE`` keeps its name and meaning: ``bfloat16`` (convs in
bf16 with float32 parameters, BatchNorm in float32), ``float32``, or
``float64`` (CPU parity runs only; the card has no fast float64 path).
"""

from __future__ import annotations

import torch

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
}


def compute_dtype(cfg, device) -> torch.dtype:
    """cfg + target device -> torch compute dtype."""
    name = cfg.TPU.COMPUTE_DTYPE
    if name not in _DTYPES:
        raise ValueError(
            f"TPU.COMPUTE_DTYPE must be one of {sorted(_DTYPES)}, "
            f"got {name!r}")
    if name == "float64" and torch.device(device).type == "cuda":
        raise ValueError("TPU.COMPUTE_DTYPE float64 is a CPU parity mode; "
                         "use float32 or bfloat16 on CUDA")
    return _DTYPES[name]


def autocast(dtype: torch.dtype, device) -> torch.autocast:
    """The context a forward runs in.  For bfloat16 it gives ``fhpe_tpu``'s
    flow on float32 parameters: convs in bf16, BatchNorm normalizing in
    float32 and emitting bf16, ReLU, pooling and residual adds in bf16.
    Other dtypes run as they are (autocast off).  Inside a CUDA graph
    capture autocast's cache of weight casts is off: PyTorch does not
    support it under graphs (the casts are then made where they are
    used, with the same values)."""
    kind = torch.device(device).type
    capturing = kind == "cuda" and torch.cuda.is_current_stream_capturing()
    return torch.autocast(kind, dtype=torch.bfloat16,
                          enabled=dtype == torch.bfloat16,
                          cache_enabled=not capturing)

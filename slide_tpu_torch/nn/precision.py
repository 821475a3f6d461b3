"""The process-wide activation dtype (counterpart: `slide_tpu/nn/precision.py`).

`set_activation_dtype("bfloat16")` makes the networks' `Linear` layers
compute in bf16 and their `GroupNorm`s emit bf16 (`nn/layers.py`): each
layer casts its input and parameters at use.  Parameters and Adam's state
stay fp32, and GroupNorm statistics are summed in float64 as always.  What
decides picks or losses is untouched, because it is not a `Linear`:

  - neighbour selection, FPS and the chamfer distances cast to fp32
    (`ops/neighbors.py::pairwise_sqdist`, `ops/fps.py`);
  - losses promote to fp32 at their fp32 targets;
  - the fused denoiser's kernels (K1, K2) keep their own precision.

This is a switch the layers read when they run, not `torch.autocast`, which
would also run the matmul-form distances of neighbour selection in bf16 and
change the picks.  The default is None (fp32).  A float64 run (a reference)
stays float64 whatever the switch says.

The environment variable SLIDE_TPU_ACT_DTYPE sets it at import; an unknown
value warns and keeps fp32.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Optional

import torch

_ACT_DTYPE: Optional[torch.dtype] = None
_NAMES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
          "float32": None, "f32": None, "none": None, "": None}


def set_activation_dtype(dtype) -> None:
    """dtype: a torch dtype, a name ("bfloat16" / "float32"), or None for fp32."""
    global _ACT_DTYPE
    if isinstance(dtype, str):
        key = dtype.lower()
        if key not in _NAMES:
            raise ValueError(f"unknown activation dtype {dtype!r}")
        dtype = _NAMES[key]
    if dtype == torch.float32:
        dtype = None
    if dtype not in (None, torch.bfloat16):
        raise ValueError(f"unsupported activation dtype {dtype}")
    _ACT_DTYPE = dtype


def activation_dtype() -> Optional[torch.dtype]:
    """The current activation dtype (None: fp32)."""
    return _ACT_DTYPE


@contextlib.contextmanager
def activation_dtype_scope(dtype):
    """Set the activation dtype for the duration of the block."""
    prev = _ACT_DTYPE
    set_activation_dtype(dtype)
    try:
        yield
    finally:
        set_activation_dtype(prev)


def compute_dtype(x: torch.Tensor) -> Optional[torch.dtype]:
    """The dtype a layer computes in for input `x`: the activation dtype,
    except that float64 input (a reference run) stays float64; None when
    the layer runs as it would without the switch."""
    if _ACT_DTYPE is None or x.dtype == torch.float64:
        return None
    return _ACT_DTYPE


# the environment's switch, read at import; a typo must not break every
# import of the package, so it warns and keeps fp32
try:
    set_activation_dtype(os.environ.get("SLIDE_TPU_ACT_DTYPE", ""))
except ValueError as _e:
    warnings.warn(f"ignoring invalid SLIDE_TPU_ACT_DTYPE: {_e}; activations stay float32",
                  stacklevel=1)

"""The precision the plain reference computes in.

"float32" is the configurations' own: float32 arithmetic, with TF32
off for every matrix product and convolution.  "lower" is the
control's, the nearest precision below it at each step: TF32 for the
matrix products (the plain patch operator's bmm and SIFT's binning
einsums; the CPU has no TF32, so there it changes nothing) and
bfloat16 for the other float32 arithmetic's storage, applied where the
ladder's levels are stored (the initial blur, each level's blur and
DoH response), the bandwidth a lower precision would save.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

PRECISIONS = ("float32", "lower")
_current = contextvars.ContextVar("reference_precision", default="float32")


@contextlib.contextmanager
def computing_in(precision: str):
    """The reference computes in `precision` inside."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    lower = precision == "lower"
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = lower
    torch.backends.cudnn.allow_tf32 = lower
    token = _current.set(precision)
    try:
        yield
    finally:
        _current.reset(token)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def stored(t: torch.Tensor) -> torch.Tensor:
    """t as the current precision stores a ladder level: unchanged in
    float32, rounded to bfloat16 in "lower"."""
    if _current.get() == "lower":
        return t.to(torch.bfloat16).to(t.dtype)
    return t

"""The precisions a reference runs in: float64 is the reference, float32
a plain single-precision run of the same code, and "tf32" the control,
the step below the float32 that the configurations state: each product's
or sum's inputs rounded to TF32 (10 mantissa bits, round to nearest
even), as a tensor core takes them, and the result kept in float32."""
from __future__ import annotations

import torch

MODES = ("float64", "float32", "tf32")


def dtype(mode: str) -> torch.dtype:
    if mode not in MODES:
        raise ValueError(f"unknown precision {mode!r}")
    return torch.float64 if mode == "float64" else torch.float32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, to nearest even
    (infinities stay)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def operand(x: torch.Tensor, mode: str) -> torch.Tensor:
    """An operation's input as the mode takes it."""
    return tf32(x) if mode == "tf32" else x

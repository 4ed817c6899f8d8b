"""Semirings and masks on torch tensors.

Counterpart of `graphlily_tpu/semiring.py`: three semirings (arithmetic,
logical, tropical) as (mul, add, one, zero) and three mask modes. The
tropical "infinity" is the finite sentinel FLOAT_INF with a saturating
add, so results match the float64 oracles bit for bit. INF_BITS and
tropical_encode/tropical_decode are the tropical engine's int32 encoding
(graphlily_tpu/ops/router_pallas.py:65-75).
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

FLOAT_INF = np.float32(999999999.0)
# The tropical engine's exact int32 encoding: for v >= 0 the float32 bit
# pattern orders as v does, so E(v) = INF_BITS - bits(min(v, FLOAT_INF))
# reverses the order exactly, with E(FLOAT_INF) = 0. A min over products
# becomes an int32 max whose identity, 0, is what a zeroed stream holds.
INF_BITS = int(FLOAT_INF.view(np.int32))


def tropical_encode(vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """E(min(vals + x, FLOAT_INF)) as int32 (one float32 add, rounded to
    nearest, as the K4 kernel computes it)."""
    p = torch.clamp_max(vals + x, float(FLOAT_INF))
    return INF_BITS - p.view(torch.int32)


def tropical_decode(e: torch.Tensor) -> torch.Tensor:
    """The inverse of tropical_encode: float32 from int32 encodings."""
    return (INF_BITS - e).view(torch.float32)


class OpType(enum.IntEnum):
    MULADD = 0
    ANDOR = 1
    ADDMIN = 2


class MaskType(enum.IntEnum):
    NO_MASK = 0
    WRITE_TO_ZERO = 1
    WRITE_TO_ONE = 2


def _bool01(b: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return b.to(like.dtype)


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A GraphBLAS semiring: `one` is the <x> identity, `zero` the <+>
    identity (and <x> annihilator)."""

    op: OpType
    one: float
    zero: float
    name: str = ""

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.op == OpType.MULADD:
            return a * b
        if self.op == OpType.ANDOR:
            return _bool01(torch.logical_and(a != 0, b != 0), a)
        if self.op == OpType.ADDMIN:
            return torch.clamp_max(a + b, float(FLOAT_INF))
        raise ValueError(f"invalid semiring op {self.op}")

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.op == OpType.MULADD:
            return a + b
        if self.op == OpType.ANDOR:
            return _bool01(torch.logical_or(a != 0, b != 0), a)
        if self.op == OpType.ADDMIN:
            return torch.minimum(a, b)
        raise ValueError(f"invalid semiring op {self.op}")

    def add_reduce(self, x: torch.Tensor, dim=None,
                   keepdim: bool = False) -> torch.Tensor:
        dims = () if dim is None else dim
        if self.op == OpType.MULADD:
            return torch.sum(x, dim=dims, keepdim=keepdim)
        if self.op == OpType.ANDOR:
            s = torch.sum(x, dim=dims, keepdim=keepdim)
            return _bool01(s != 0, s)
        if self.op == OpType.ADDMIN:
            return torch.amin(x, dim=dims, keepdim=keepdim)
        raise ValueError(f"invalid semiring op {self.op}")


ArithmeticSemiring = Semiring(OpType.MULADD, one=1.0, zero=0.0,
                              name="arithmetic")
LogicalSemiring = Semiring(OpType.ANDOR, one=1.0, zero=0.0, name="logical")
TropicalSemiring = Semiring(OpType.ADDMIN, one=0.0, zero=float(FLOAT_INF),
                            name="tropical")

SEMIRINGS = {
    "arithmetic": ArithmeticSemiring,
    "logical": LogicalSemiring,
    "tropical": TropicalSemiring,
}


def apply_mask(results: torch.Tensor, mask: torch.Tensor,
               mask_type: MaskType, zero) -> torch.Tensor:
    """Masked write-back, SpMV flavor: compares and fills with a literal 0
    (not the semiring zero). WRITE_TO_ZERO keeps results where mask == 0,
    WRITE_TO_ONE where mask != 0."""
    del zero
    if mask_type == MaskType.NO_MASK:
        return results
    fill = torch.zeros((), dtype=results.dtype, device=results.device)
    if mask_type == MaskType.WRITE_TO_ZERO:
        return torch.where(mask == 0, results, fill)
    if mask_type == MaskType.WRITE_TO_ONE:
        return torch.where(mask == 0, fill, results)
    raise ValueError(f"invalid mask type {mask_type}")


def apply_mask_sparse_style(results: torch.Tensor, mask: torch.Tensor,
                            mask_type: MaskType, zero) -> torch.Tensor:
    """Masked write-back, SpMSpV flavor: masked-off entries become the
    semiring zero, and the mask is compared against the semiring zero. The
    zero stays a Python number: a device tensor made from it would be a
    host-to-device copy, which waits for the device, on every push step."""
    if mask_type == MaskType.NO_MASK:
        return results
    z = float(torch.tensor(zero, dtype=results.dtype))   # rounded to dtype
    if mask_type == MaskType.WRITE_TO_ONE:
        return torch.where(mask == z, z, results)
    if mask_type == MaskType.WRITE_TO_ZERO:
        return torch.where(mask != z, z, results)
    raise ValueError(f"invalid mask type {mask_type}")

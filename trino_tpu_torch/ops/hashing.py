"""64-bit hashing for joins and group-by, over int64 carriers of u64.

Counterpart of ``trino_tpu/ops/hashing.py``: a splitmix64 finalizer per
key column, combined across columns by CombineHashFunction's
``h = 31 * h + x``.

Torch has no unsigned 64-bit arithmetic (``>>``, ``%`` and ``+`` are not
implemented for ``torch.uint64``), so a u64 value is carried as the same
64-bit pattern in an int64 tensor: multiply, xor and add wrap alike in
two's complement; a logical right shift is the arithmetic shift with the
copied sign bits masked off; an unsigned remainder is built from the
non-negative ``x >>> 1``; unsigned order is signed order after flipping
the sign bit (``to_signed_order``). The device TPC-H generator
(connectors/tpch_device.py) uses the same helpers.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

_I64 = torch.int64
_M64 = (1 << 64) - 1
SIGN_BIT = -(1 << 63)          # the int64 pattern of 1 << 63
INT64_MAX = (1 << 63) - 1      # u64 max after the sign flip


def s64(u: int) -> int:
    """The int64 with the bit pattern of the unsigned ``u mod 2^64``."""
    u &= _M64
    return u - (1 << 64) if u >= (1 << 63) else u


_C1 = s64(0xBF58476D1CE4E5B9)
_C2 = s64(0x94D049BB133111EB)
GOLDEN = s64(0x9E3779B97F4A7C15)


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of a u64 pattern held in int64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def umod(x: torch.Tensor, m: int) -> torch.Tensor:
    """Unsigned remainder of a u64 pattern by 0 < m < 2^62: with
    x = 2h + b (h = x >>> 1 >= 0), x mod m = (2 (h mod m) + b) mod m."""
    return (2 * (shr(x, 1) % m) + (x & 1)) % m


def partition_of(h: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """A u64 hash (int64 carrier) to its bucket in [0, num_partitions):
    the unsigned remainder, as the JAX package's ``h % n`` on uint64."""
    return umod(h, int(num_partitions))


def to_signed_order(x: torch.Tensor) -> torch.Tensor:
    """Map u64 patterns to int64 values with the same order: flip the
    sign bit. Sorting and ``searchsorted`` then run on int64."""
    return x ^ SIGN_BIT


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer over a u64 lane (int64 carrier)."""
    x = x.to(_I64)
    x = x ^ shr(x, 30)
    x = x * _C1
    x = x ^ shr(x, 27)
    x = x * _C2
    x = x ^ shr(x, 31)
    return x


def float_equality_lanes(d: torch.Tensor):
    """Exact equality-preserving decomposition of a float lane into two
    int64 lanes (mantissa * 2^53, exponent). Canonicalises -0.0 == 0.0
    and all NaNs equal (SQL distinct-from semantics)."""
    d = d.to(torch.float64)
    d = torch.where(d == 0.0, torch.zeros_like(d), d)
    isnan = torch.isnan(d)
    special = isnan | torch.isinf(d)
    safe = torch.where(special, torch.zeros_like(d), d)
    m, e = torch.frexp(safe)
    mi = (m * float(1 << 53)).to(_I64)
    ex = e.to(_I64)
    code = torch.where(isnan, 1, torch.where(d > 0, 2, 3)).to(_I64)
    mi = torch.where(special, code, mi)
    ex = torch.where(special, torch.full_like(ex, 5000), ex)
    return mi, ex


def equality_lanes(data: torch.Tensor) -> List[torch.Tensor]:
    """u64 lanes (int64 carriers) whose tuple equality is SQL equality
    of the value lane: one lane for ints, bools and codes; two for
    floats."""
    if data.is_floating_point():
        return list(float_equality_lanes(data))
    return [data.to(_I64)]


def lane_to_u64(data: torch.Tensor) -> torch.Tensor:
    """One u64 lane for hashing: the bijective cast for ints and bools;
    for floats, a mix of the two equality lanes."""
    if data.is_floating_point():
        mi, ex = float_equality_lanes(data)
        return mix64(mi) + ex
    return data.to(_I64)


def hash_column(data: torch.Tensor,
                valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-row 64-bit hash of one lane; NULL hashes to 0."""
    h = mix64(lane_to_u64(data))
    if valid is not None:
        h = torch.where(valid, h, torch.zeros_like(h))
    return h


def combine_hashes(hashes: Sequence[torch.Tensor]) -> torch.Tensor:
    """CombineHashFunction.getHash: h = 31 * h + x, then mix."""
    acc = torch.full_like(hashes[0], GOLDEN)
    for h in hashes:
        acc = acc * 31 + h
    return mix64(acc)


def hash_columns(cols) -> torch.Tensor:
    """Hash a list of Columns into one u64 lane (int64 carrier): each
    column's value lane (a string column's dictionary codes) hashed and
    combined, NULL hashing to 0, as the JAX package's ``hash_columns``."""
    return combine_hashes([hash_column(c.data, c.valid) for c in cols])

"""Int128 lane arithmetic for DECIMAL(p>18), over torch int64 lanes.

Counterpart of ``trino_tpu/ops/int128.py``, function for function. A long
decimal is a pair of int64 lanes ``(lo, hi)`` emulating a two's-complement
128-bit integer: ``value = hi * 2^64 + u64(lo)`` (columnar.py stores
``hi`` in ``Column.data2``).

Torch has no unsigned 64-bit arithmetic, so every lane stays int64:
unsigned order flips the sign bit first (``_ult``), multiplication runs
on 16-bit limbs so every partial product and carry stays far below 2^63,
and integer add/mul wrap in two's complement as the algorithms need.
Division is a shift-subtract loop of 128 steps, one bit per step, each
step a handful of whole-lane tensor ops (the JAX engine's
``lax.fori_loop``, unrolled in Python). Nothing divides by a float, so
CUDA's reciprocal-multiply of a python-scalar divisor never applies.

Overflow beyond 128 bits wraps rather than raising DECIMAL_OVERFLOW, as
in the JAX engine; results within DECIMAL(38) range are exact.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .hashing import SIGN_BIT

_I64 = torch.int64
_M16 = (1 << 16) - 1

# calls of divmod128u (each one 128 shift-subtract steps), for the
# card's phase that reports how often the division loop ran
DIVMOD_CALLS = 0


# --------------------------------------------------------------------------
# host-side constant splitting
# --------------------------------------------------------------------------

def split_const(q: int) -> Tuple[int, int]:
    """Python int -> (lo, hi) signed-int64 Python ints (two's
    complement). |q| must be < 2^127."""
    lo = q & ((1 << 64) - 1)
    if lo >= (1 << 63):
        lo -= 1 << 64
    hi = q >> 64
    if not (-(1 << 63) <= hi < (1 << 63)):
        raise OverflowError(f"constant exceeds 128 bits: {q}")
    return lo, hi


def combine_host(lo: int, hi: int) -> int:
    """(lo, hi) int64 pair -> Python int (exact)."""
    return (int(hi) << 64) + (int(lo) & ((1 << 64) - 1))


# --------------------------------------------------------------------------
# lane primitives
# --------------------------------------------------------------------------

def sign_extend(lo: torch.Tensor) -> torch.Tensor:
    """hi lane for a value currently held in a single int64 lane."""
    return lo >> 63


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """unsigned a < b on int64 lanes (sign-bit flip)."""
    return (a ^ SIGN_BIT) < (b ^ SIGN_BIT)


def add128(alo, ahi, blo, bhi):
    lo = alo + blo
    return lo, ahi + bhi + _ult(lo, alo).to(_I64)


def neg128(lo, hi):
    return -lo, -hi - (lo != 0).to(_I64)


def sub128(alo, ahi, blo, bhi):
    return add128(alo, ahi, *neg128(blo, bhi))


def abs128(lo, hi):
    neg = hi < 0
    nlo, nhi = neg128(lo, hi)
    return torch.where(neg, nlo, lo), torch.where(neg, nhi, hi)


def eq128(alo, ahi, blo, bhi):
    return (alo == blo) & (ahi == bhi)


def lt128(alo, ahi, blo, bhi):
    """signed 128-bit a < b."""
    return (ahi < bhi) | ((ahi == bhi) & _ult(alo, blo))


def uge128(alo, ahi, blo, bhi):
    """unsigned 128-bit a >= b."""
    gt = (ahi ^ SIGN_BIT) > (bhi ^ SIGN_BIT)
    return gt | ((ahi == bhi) & ~_ult(alo, blo))


def shl1(lo, hi):
    return lo << 1, (hi << 1) | ((lo >> 63) & 1)


# --------------------------------------------------------------------------
# multiplication (mod 2^128), 16-bit limbs
# --------------------------------------------------------------------------

def _limbs(lo, hi):
    return [(w >> (16 * i)) & _M16 for w in (lo, hi) for i in range(4)]


def _from_limbs(limbs):
    packed = []
    carry = torch.zeros_like(limbs[0])
    for k in range(8):
        v = limbs[k] + carry
        packed.append(v & _M16)
        carry = v >> 16
    lo = packed[0] | (packed[1] << 16) | (packed[2] << 32) | (packed[3] << 48)
    hi = packed[4] | (packed[5] << 16) | (packed[6] << 32) | (packed[7] << 48)
    return lo, hi


def mul128(alo, ahi, blo, bhi):
    """full product mod 2^128 (correct for signed two's complement)."""
    a = _limbs(alo, ahi)
    b = _limbs(blo, bhi)
    r = [torch.zeros_like(alo) for _ in range(8)]
    for i in range(8):
        for j in range(8 - i):
            r[i + j] = r[i + j] + a[i] * b[j]
    return _from_limbs(r)


def mul_const(lo, hi, c: int):
    """multiply by a non-negative Python-int constant, mod 2^128."""
    if c < 0:
        raise ValueError("mul_const expects c >= 0")
    climbs = [(c >> (16 * i)) & _M16 for i in range(8)]
    a = _limbs(lo, hi)
    r = [torch.zeros_like(lo) for _ in range(8)]
    for i in range(8):
        if climbs[i] == 0:
            continue
        for j in range(8 - i):
            r[i + j] = r[i + j] + a[j] * climbs[i]
    return _from_limbs(r)


# --------------------------------------------------------------------------
# division
# --------------------------------------------------------------------------

def divmod128u(vlo, vhi, dlo, dhi):
    """unsigned 128 / unsigned 128 -> (qlo, qhi, rlo, rhi).

    Shift-subtract long division, one bit per step, over all rows at
    once; d == 0 yields q = 0, r = v (callers guard)."""
    global DIVMOD_CALLS
    DIVMOD_CALLS += 1
    zero = torch.zeros_like(vlo)
    d_zero = (dlo == 0) & (dhi == 0)
    dlo_s = torch.where(d_zero, torch.ones_like(dlo), dlo)
    qlo, qhi, rlo, rhi = zero, zero, zero, zero
    for k in range(127, -1, -1):
        bit = ((vhi >> (k - 64)) if k >= 64 else (vlo >> k)) & 1
        rlo, rhi = shl1(rlo, rhi)
        rlo = rlo | bit
        ge = uge128(rlo, rhi, dlo_s, dhi)
        slo, shi = sub128(rlo, rhi, dlo_s, dhi)
        rlo = torch.where(ge, slo, rlo)
        rhi = torch.where(ge, shi, rhi)
        qb = ge.to(_I64)
        if k >= 64:
            qhi = qhi | (qb << (k - 64))
        else:
            qlo = qlo | (qb << k)
    return (torch.where(d_zero, zero, qlo), torch.where(d_zero, zero, qhi),
            torch.where(d_zero, vlo, rlo), torch.where(d_zero, vhi, rhi))


def _round_up(qlo, qhi, rlo, rhi, dlo, dhi):
    """q + 1 where 2r >= d (HALF_UP on magnitudes)."""
    r2lo, r2hi = shl1(rlo, rhi)
    up = uge128(r2lo, r2hi, dlo, dhi).to(_I64)
    return add128(qlo, qhi, up, torch.zeros_like(qhi))


def div128_round_half_up(lo, hi, d: int):
    """signed (lo, hi) / positive Python-int d, HALF_UP away from zero
    (the reference's Decimals rescale rounding)."""
    if d <= 0:
        raise ValueError("divisor must be positive")
    neg = hi < 0
    alo, ahi = abs128(lo, hi)
    dl, dh = split_const(d)
    dlo = torch.full_like(lo, dl)
    dhi = torch.full_like(hi, dh)
    qlo, qhi, rlo, rhi = divmod128u(alo, ahi, dlo, dhi)
    qlo, qhi = _round_up(qlo, qhi, rlo, rhi, dlo, dhi)
    nlo, nhi = neg128(qlo, qhi)
    return torch.where(neg, nlo, qlo), torch.where(neg, nhi, qhi)


def div128_round_half_up_pair(alo, ahi, blo, bhi):
    """signed 128 / signed 128, HALF_UP away from zero (per-row
    divisor: the decimal division)."""
    q_neg = (ahi < 0) ^ (bhi < 0)
    aal, aah = abs128(alo, ahi)
    abl, abh = abs128(blo, bhi)
    qlo, qhi, rlo, rhi = divmod128u(aal, aah, abl, abh)
    qlo, qhi = _round_up(qlo, qhi, rlo, rhi, abl, abh)
    nlo, nhi = neg128(qlo, qhi)
    return torch.where(q_neg, nlo, qlo), torch.where(q_neg, nhi, qhi)


def div128_round_half_up_scaled(lo, hi, count, pow10: int):
    """signed (lo, hi) / (count * 10^pow10) with ONE HALF_UP rounding
    (the decimal-average down-rescale: dividing by the count and then
    rescaling down would round twice). ``count`` lanes must be positive
    int64."""
    if pow10 < 0:
        raise ValueError("pow10 must be non-negative")
    dlo, dhi = mul_const(count, torch.zeros_like(count), 10 ** pow10)
    return div128_round_half_up_pair(lo, hi, dlo, dhi)


def divmod128_trunc(alo, ahi, blo, bhi):
    """signed 128/128 truncating division (SQL integer-division and %
    semantics: quotient toward zero, remainder keeps the sign of a)."""
    a_neg = ahi < 0
    q_neg = a_neg ^ (bhi < 0)
    aal, aah = abs128(alo, ahi)
    abl, abh = abs128(blo, bhi)
    qlo, qhi, rlo, rhi = divmod128u(aal, aah, abl, abh)
    nql, nqh = neg128(qlo, qhi)
    nrl, nrh = neg128(rlo, rhi)
    return (torch.where(q_neg, nql, qlo), torch.where(q_neg, nqh, qhi),
            torch.where(a_neg, nrl, rlo), torch.where(a_neg, nrh, rhi))


# --------------------------------------------------------------------------
# rescale / conversions
# --------------------------------------------------------------------------

def rescale(lo, hi, shift: int):
    """value * 10^shift (shift > 0) or HALF_UP divide (shift < 0)."""
    if shift == 0:
        return lo, hi
    if shift > 0:
        return mul_const(lo, hi, 10 ** shift)
    return div128_round_half_up(lo, hi, 10 ** (-shift))


def to_double(lo, hi) -> torch.Tensor:
    """value as float64: (hi + [lo < 0]) * 2^64 + signed(lo), which keeps
    small negative values exact (hi * 2^64 + u64(lo) would cancel)."""
    hi_adj = hi + (lo < 0).to(_I64)
    return (hi_adj.to(torch.float64) * 2.0 ** 64
            + lo.to(torch.float64))


def from_double(x: torch.Tensor):
    """float64 -> (lo, hi), truncating toward zero beyond float
    precision (float64 has 53 mantissa bits). The divisor 2^64 is a
    power of two, so its reciprocal is exact."""
    neg = x < 0
    ax = torch.abs(x)
    hi_f = torch.floor(ax * 2.0 ** -64)
    lo_f = ax - hi_f * 2.0 ** 64
    # lo_f in [0, 2^64): map to two's-complement int64
    lo = torch.where(lo_f >= 2.0 ** 63, lo_f - 2.0 ** 64, lo_f).to(_I64)
    hi = hi_f.to(_I64)
    nlo, nhi = neg128(lo, hi)
    return torch.where(neg, nlo, lo), torch.where(neg, nhi, hi)


# --------------------------------------------------------------------------
# segment sums (aggregation support)
# --------------------------------------------------------------------------

def sum_lanes(lo, hi):
    """Decompose (lo, hi) into three int64 addend lanes (w0, w1, hi)
    with value = w0 + w1*2^32 + hi*2^64 and 0 <= w0, w1 < 2^32, so any
    per-group sum of up to 2^31 rows stays exact in int64."""
    return lo & 0xFFFFFFFF, (lo >> 32) & 0xFFFFFFFF, hi


def combine_sums(s0, s1, s2):
    """Recombine summed lanes into (lo, hi): s0 + s1*2^32 + s2*2^64
    (mod 2^128)."""
    lo, hi = add128(s0, torch.zeros_like(s0), s1 << 32, s1 >> 32)
    return lo, hi + s2

"""Vectorized modular arithmetic on uint64 lanes.

This is the arithmetic substrate the whole framework stands on — the
vectorized replacement for SEAL's ``seal::util::*`` scalar kernels
(``barrett_reduce_128``, ``multiply_uint_mod``, ``add_poly_coeffmod``, …)
that every reference call site depends on (see SURVEY §2b).

Everything operates on ``uint64`` JAX arrays with wrap-around semantics.
Moduli are at most 61 bits, so ``x + y`` of two reduced values never wraps,
and a 128-bit product is handled as an explicit (hi, lo) pair built from
32-bit half-products.  Two reduction strategies:

* **Barrett** for variable×variable products, using the precomputed
  128-bit ratio floor(2^128 / q) split into two u64 words.
* **Shoup** for constant×variable products (NTT twiddles, key-switch
  scale-down constants): one mulhi + two mullo per multiply.  The
  constant's companion word floor(w·2^64 / q) is precomputed host-side.

Sums of many products skip both: ``sum_products_128`` accumulates them
unreduced and the caller reduces the 128-bit total once.

The 32-bit splits below keep every partial product a 32x32->64 multiply,
which the backends emit as native wide multiplies.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_M32 = np.uint64(0xFFFFFFFF)
_U64 = np.uint64


def to_u64(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=jnp.uint64)


# ---------------------------------------------------------------------------
# 64x64 -> 128 bit products
# ---------------------------------------------------------------------------


def mul64_wide(x, y):
    """Full 128-bit product of two u64 arrays, as a (hi, lo) pair of u64."""
    x0 = x & _M32
    x1 = x >> _U64(32)
    y0 = y & _M32
    y1 = y >> _U64(32)
    lolo = x0 * y0
    hilo = x1 * y0
    lohi = x0 * y1
    hihi = x1 * y1
    mid = (lolo >> _U64(32)) + (hilo & _M32) + (lohi & _M32)
    lo = (mid << _U64(32)) | (lolo & _M32)
    hi = hihi + (hilo >> _U64(32)) + (lohi >> _U64(32)) + (mid >> _U64(32))
    return hi, lo


def mulhi64(x, y):
    """High 64 bits of the 128-bit product."""
    return mul64_wide(x, y)[0]


def _low32(x):
    # truncate-then-widen (not a mask) so the backend sees zero-extended
    # operands and can emit one 32x32->64 multiply per partial product
    return x.astype(jnp.uint32).astype(jnp.uint64)


def sum_products_128(x, y, axis: int):
    """Exact Σ x·y along ``axis``, unreduced, as a (hi, lo) u64 pair.

    The products are split into three column sums of their 32-bit pieces
    (low word of x0·y0, the carry word plus the cross terms, x1·y1), so the
    whole contraction is one fused multiply-reduce with no modular
    reduction per term.  For operands below 2^b the middle column grows by
    < 2^(b+2) per term: the caller keeps the axis at most 2^(62-b) long.
    """
    x0, y0 = _low32(x), _low32(y)
    x1, y1 = x >> _U64(32), y >> _U64(32)
    ll = x0 * y0
    s0 = jnp.sum(ll & _M32, axis=axis)
    s1 = jnp.sum((ll >> _U64(32)) + x0 * y1 + x1 * y0, axis=axis)
    s2 = jnp.sum(x1 * y1, axis=axis)
    lo = s0 + (s1 << _U64(32))
    carry = (lo < s0).astype(jnp.uint64)
    return s2 + (s1 >> _U64(32)) + carry, lo


# ---------------------------------------------------------------------------
# Barrett reduction
# ---------------------------------------------------------------------------


def barrett_ratio(q: int) -> tuple[int, int]:
    """floor(2^128 / q) split into (hi, lo) u64 words.  Host-side."""
    r = (1 << 128) // q
    return (r >> 64) & 0xFFFFFFFFFFFFFFFF, r & 0xFFFFFFFFFFFFFFFF


def barrett_reduce_128(hi, lo, q, ratio_hi, ratio_lo):
    """Reduce a 128-bit value (hi, lo) modulo q (q < 2^62).

    Base-2^64 Barrett reduction: estimate the quotient as the top word of
    (value * floor(2^128/q)) >> 128, then correct with a single conditional
    subtract.  All intermediates wrap mod 2^64 by construction.
    """
    # Round 1: lo * ratio
    carry = mulhi64(lo, ratio_lo)
    t2_hi, t2_lo = mul64_wide(lo, ratio_hi)
    tmp1 = t2_lo + carry
    carry2 = (tmp1 < t2_lo).astype(jnp.uint64)
    tmp3 = t2_hi + carry2
    # Round 2: hi * ratio
    t4_hi, t4_lo = mul64_wide(hi, ratio_lo)
    tmp1b = tmp1 + t4_lo
    carry3 = (tmp1b < t4_lo).astype(jnp.uint64)
    carry4 = t4_hi + carry3
    # Quotient estimate (only the low 64 bits matter)
    quot = hi * ratio_hi + tmp3 + carry4
    r = lo - quot * q
    return jnp.where(r >= q, r - q, r)


def barrett_reduce_64(x, q, ratio_hi):
    """Reduce a u64 value modulo q using the high ratio word only."""
    quot = mulhi64(x, ratio_hi)
    r = x - quot * q
    return jnp.where(r >= q, r - q, r)


# ---------------------------------------------------------------------------
# Reduced-operand primitives (inputs in [0, q))
# ---------------------------------------------------------------------------


def add_mod(x, y, q):
    s = x + y  # < 2^62, no wrap
    return jnp.where(s >= q, s - q, s)


def sub_mod(x, y, q):
    return jnp.where(x >= y, x - y, x + q - y)


def neg_mod(x, q):
    return jnp.where(x == 0, x, q - x)


def mul_mod(x, y, q, ratio_hi, ratio_lo):
    hi, lo = mul64_wide(x, y)
    return barrett_reduce_128(hi, lo, q, ratio_hi, ratio_lo)


def shoup_precompute(w, q) -> np.ndarray:
    """Companion word floor(w * 2^64 / q) for Shoup multiplication.

    Host-side numpy (object ints) — w and q may be arrays.
    """
    w_obj = np.asarray(w, dtype=object)
    q_obj = np.asarray(q, dtype=object)
    res = (w_obj * (1 << 64)) // q_obj
    return np.asarray(res, dtype=np.uint64)


def mul_mod_shoup(x, w, w_shoup, q):
    """x*w mod q with precomputed Shoup companion for the constant w.

    Requires x < q (any w < q).  One mulhi + two mullo.
    """
    q_est = mulhi64(x, w_shoup)
    r = x * w - q_est * q
    return jnp.where(r >= q, r - q, r)


# ---------------------------------------------------------------------------
# Per-limb modulus constants
# ---------------------------------------------------------------------------


class LimbConstants:
    """Precomputed per-RNS-limb constants, shaped to broadcast over [..., L, N].

    ``q``/``ratio_hi``/``ratio_lo`` have shape [L, 1] so that any polynomial
    array laid out with the limb axis second-to-last broadcasts directly.
    """

    def __init__(self, moduli: "list[int] | tuple[int, ...]"):
        self.moduli = tuple(int(m) for m in moduli)
        L = len(self.moduli)
        q = np.zeros((L, 1), dtype=np.uint64)
        rh = np.zeros((L, 1), dtype=np.uint64)
        rl = np.zeros((L, 1), dtype=np.uint64)
        for i, m in enumerate(self.moduli):
            hi, lo = barrett_ratio(m)
            q[i, 0] = m
            rh[i, 0] = hi
            rl[i, 0] = lo
        self.q = q
        self.ratio_hi = rh
        self.ratio_lo = rl

    def __len__(self) -> int:
        return len(self.moduli)

    def slice(self, count: int) -> "LimbConstants":
        """Constants for the first `count` limbs (e.g. drop the special prime)."""
        return LimbConstants(self.moduli[:count])

    # Elementwise ops over [..., L, N] arrays -------------------------------
    def add(self, x, y):
        return add_mod(x, y, self.q)

    def sub(self, x, y):
        return sub_mod(x, y, self.q)

    def neg(self, x):
        return neg_mod(x, self.q)

    def mul(self, x, y):
        return mul_mod(x, y, self.q, self.ratio_hi, self.ratio_lo)

    def reduce(self, x):
        return barrett_reduce_64(x, self.q, self.ratio_hi)

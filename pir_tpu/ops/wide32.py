"""64-bit arithmetic on u32 word pairs, in plain jnp.

Every 64-bit quantity is an explicit (hi, lo) pair of uint32 arrays and
every 32×32 product is built from 16-bit half-products (exact in u32).
The key switch's digit inner product (ops/keyswitch.py) accumulates its
raw products in these words: three-word products, exact 16-bit-half
column sums, and one 96-bit Barrett reduction per output.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_M16 = np.uint32(0xFFFF)
_U32_1 = np.uint32(1)


def mul32_wide(a, b):
    """Full 64-bit product of u32 arrays -> (hi32, lo32)."""
    a0 = a & _M16
    a1 = a >> 16
    b0 = b & _M16
    b1 = b >> 16
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    mid = (ll >> 16) + (lh & _M16) + (hl & _M16)  # < 3·2^16, fits u32
    lo = (mid << 16) | (ll & _M16)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def add64(xh, xl, yh, yl):
    """(x + y) mod 2^64 on pairs."""
    lo = xl + yl
    carry = (lo < xl).astype(jnp.uint32)
    return xh + yh + carry, lo


def sub64(xh, xl, yh, yl):
    """(x - y) mod 2^64 on pairs."""
    borrow = (xl < yl).astype(jnp.uint32)
    return xh - yh - borrow, xl - yl


def ge64(xh, xl, yh, yl):
    return (xh > yh) | ((xh == yh) & (xl >= yl))


def mullo64(xh, xl, yh, yl):
    """Low 64 bits of the 128-bit product, as a pair."""
    h, l = mul32_wide(xl, yl)
    return h + xl * yh + xh * yl, l


def mulhi64(xh, xl, yh, yl):
    """High 64 bits of the 128-bit product, as a pair."""
    # partial products: xl·yl (low), xl·yh + xh·yl (mid, <<32), xh·yh (<<64)
    h1, _l1 = mul32_wide(xl, yl)
    h2, l2 = mul32_wide(xl, yh)
    h3, l3 = mul32_wide(xh, yl)
    h4, l4 = mul32_wide(xh, yh)
    # mid sum: (h1 + l2 + l3) with carries feeding the high words
    m1 = h1 + l2
    c1 = (m1 < h1).astype(jnp.uint32)
    m2 = m1 + l3
    c2 = (m2 < m1).astype(jnp.uint32)
    # hi64 = xh·yh + (h2 + h3 + carries) + (mid >> 32 is m2's carry chain)
    lo_out = l4 + h2
    cc1 = (lo_out < l4).astype(jnp.uint32)
    lo_out2 = lo_out + h3
    cc2 = (lo_out2 < lo_out).astype(jnp.uint32)
    lo_out3 = lo_out2 + c1 + c2
    cc3 = (lo_out3 < lo_out2).astype(jnp.uint32)
    return h4 + cc1 + cc2 + cc3, lo_out3


# ---------------------------------------------------------------------------
# Raw-product accumulation (operands below 2^48)
#
# With moduli of b <= 48 bits the full 2b-bit product fits three u32 words,
# and a whole contraction can be accumulated unreduced (sum < 2^96) with
# ONE Barrett reduction per output element.
# ---------------------------------------------------------------------------


def mul_u48_3w(xh, xl, wh, wl):
    """(x * w) for x, w < 2^48 -> three u32 words (p2, p1, p0).

    Requires xh, wh < 2^16 (i.e. both operands below 2^48).  9 multiplies.
    """
    # low x low: full 32x32 -> 64
    ll_hi, ll_lo = mul32_wide(xl, wl)  # 4 muls
    # xl * wh  (wh < 2^16): split xl into 16-bit halves -> < 2^48
    a0 = xl & _M16
    a1 = xl >> 16
    m1 = a0 * wh  # < 2^32
    m2 = a1 * wh  # < 2^32
    xlwh_lo = m1 + (m2 << 16)
    c_a = (xlwh_lo < m1).astype(jnp.uint32)
    xlwh_hi = (m2 >> 16) + c_a  # < 2^16
    # xh * wl  (xh < 2^16)
    b0 = wl & _M16
    b1 = wl >> 16
    n1 = xh * b0
    n2 = xh * b1
    xhwl_lo = n1 + (n2 << 16)
    c_b = (xhwl_lo < n1).astype(jnp.uint32)
    xhwl_hi = (n2 >> 16) + c_b  # < 2^16
    # xh * wh < 2^32
    hh = xh * wh
    # combine: p0 = ll_lo; middle word = ll_hi + xlwh_lo + xhwl_lo
    p1 = ll_hi + xlwh_lo
    c1 = (p1 < ll_hi).astype(jnp.uint32)
    p1b = p1 + xhwl_lo
    c2 = (p1b < p1).astype(jnp.uint32)
    p2 = hh + xlwh_hi + xhwl_hi + c1 + c2  # < 2^32 (2b - 64 <= 32)
    return p2, p1b, ll_lo


def sum96_over_axis(p2, p1, p0, axis, p2_max_bits: int = 32):
    """Exact sum of 3-word products along `axis` (< 2^16 terms).

    Each u32 word is split into 16-bit halves so the per-half partial sums
    stay exact in u32, then the halves are recombined with carries.
    Returns (s2, s1, s0) u32 words of the 96-bit total (must not overflow).

    p2_max_bits: static bound on the top word's width.  Products of
    b-bit moduli have p2 < 2^(2b-64); for b <= 40 that is <= 16 bits, so
    the top word's high half is identically zero and its partial sum,
    shift, and recombination carries drop out.
    """
    # sum the halves as i32 (two's-complement wrap == u32 wrap) and
    # reinterpret back; the halves are sized so the 32-bit accumulation is
    # exact mod 2^32
    def _s(x):
        return jnp.sum(
            x.astype(jnp.int32), axis=axis, dtype=jnp.int32
        ).astype(jnp.uint32)

    lo0 = _s(p0 & _M16)
    hi0 = _s(p0 >> 16)
    lo1 = _s(p1 & _M16)
    hi1 = _s(p1 >> 16)
    if p2_max_bits <= 16:
        lo2 = _s(p2)  # hi half identically zero: one sum, no split
        hi2 = None
    else:
        lo2 = _s(p2 & _M16)
        hi2 = _s(p2 >> 16)
    # word 0 = lo0 + (hi0 << 16); carries ripple upward
    s0 = lo0 + (hi0 << 16)
    c0 = (s0 < lo0).astype(jnp.uint32)
    t0 = (hi0 >> 16) + c0  # overflow of word 0 into word 1
    s1a = lo1 + t0
    c1a = (s1a < lo1).astype(jnp.uint32)
    s1 = s1a + (hi1 << 16)
    c1b = (s1 < s1a).astype(jnp.uint32)
    t1 = (hi1 >> 16) + c1a + c1b
    s2 = lo2 + t1 if hi2 is None else lo2 + (hi2 << 16) + t1
    return s2, s1, s0


def barrett_reduce96_w(x2, x1, x0, qh, ql, rhh, rhl, rlh, rll):
    """x mod q for a 96-bit x = (x2, x1, x0) u32 words; q < 2^62.

    Mirrors modular.barrett_reduce_128 with hi = (0, x2), lo = (x1, x0).
    The modulus and its Barrett ratio come pre-split into u32 words
    (qh, ql, ratio_hi words, ratio_lo words); they may be traced arrays."""
    # Round 1: carry = mulhi64(lo, ratio_lo)
    ch, cl = mulhi64(x1, x0, rlh, rll)
    # t2 = lo * ratio_hi (full 128: hi pair + lo pair)
    t2hh, t2hl = mulhi64(x1, x0, rhh, rhl)
    t2lh, t2ll = mullo64(x1, x0, rhh, rhl)
    tmp1h, tmp1l = add64(t2lh, t2ll, ch, cl)
    carry2 = (
        (tmp1h < t2lh) | ((tmp1h == t2lh) & (tmp1l < t2ll))
    ).astype(jnp.uint32)
    tmp3h, tmp3l = add64(t2hh, t2hl, jnp.zeros_like(carry2), carry2)
    # Round 2: hi * ratio_lo with hi = (0, x2): 64x64 where hi word is x2
    t4hh, t4hl = mulhi64(jnp.zeros_like(x2), x2, rlh, rll)
    t4lh, t4ll = mullo64(jnp.zeros_like(x2), x2, rlh, rll)
    tmp1bh, tmp1bl = add64(tmp1h, tmp1l, t4lh, t4ll)
    carry3 = (
        (tmp1bh < t4lh) | ((tmp1bh == t4lh) & (tmp1bl < t4ll))
    ).astype(jnp.uint32)
    c4h, c4l = add64(t4hh, t4hl, jnp.zeros_like(carry3), carry3)
    # quot (low 64 bits) = hi*ratio_hi + tmp3 + carry4; hi = (0, x2)
    hrh, hrl = mullo64(jnp.zeros_like(x2), x2, rhh, rhl)
    qth, qtl = add64(hrh, hrl, tmp3h, tmp3l)
    qth, qtl = add64(qth, qtl, c4h, c4l)
    # r = lo - quot * q (mod 2^64)
    mh, ml = mullo64(qth, qtl, qh, ql)
    rh, rl = sub64(x1, x0, mh, ml)
    over = ge64(rh, rl, qh, ql)
    rh2, rl2 = sub64(rh, rl, qh, ql)
    return jnp.where(over, rh2, rh), jnp.where(over, rl2, rl)


# ---------------------------------------------------------------------------
# u64 <-> pair conversions
# ---------------------------------------------------------------------------


def split_u64(x):
    """u64 array -> (hi u32, lo u32)."""
    return (x >> jnp.uint64(32)).astype(jnp.uint32), (
        x & jnp.uint64(0xFFFFFFFF)
    ).astype(jnp.uint32)


def join_u64(hi, lo):
    return (hi.astype(jnp.uint64) << jnp.uint64(32)) | lo.astype(jnp.uint64)

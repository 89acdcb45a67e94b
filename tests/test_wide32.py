"""u32-pair arithmetic (the key switch's raw-accumulation words)."""

import numpy as np
import jax.numpy as jnp
import pytest

from pir_tpu.core import primes
from pir_tpu.ops import modular, wide32

M64 = (1 << 64) - 1


def _pairs(vals):
    v = jnp.asarray(np.asarray(vals, dtype=np.uint64))
    return wide32.split_u64(v)


def _join(h, l):
    return np.asarray(wide32.join_u64(h, l)).astype(object)


def test_mul32_wide(rng):
    a = rng.integers(0, 1 << 32, size=1000, dtype=np.uint32)
    b = rng.integers(0, 1 << 32, size=1000, dtype=np.uint32)
    hi, lo = wide32.mul32_wide(jnp.asarray(a), jnp.asarray(b))
    prod = a.astype(object) * b.astype(object)
    assert (np.asarray(hi).astype(object) == prod >> 32).all()
    assert (np.asarray(lo).astype(object) == prod & 0xFFFFFFFF).all()


def test_mullo_mulhi_64(rng):
    x = rng.integers(0, 1 << 63, size=1000, dtype=np.uint64) * 2 + 1
    y = rng.integers(0, 1 << 63, size=1000, dtype=np.uint64)
    xh, xl = _pairs(x)
    yh, yl = _pairs(y)
    prod = x.astype(object) * y.astype(object)
    lh, ll = wide32.mullo64(xh, xl, yh, yl)
    assert (_join(lh, ll) == prod & M64).all()
    hh, hl = wide32.mulhi64(xh, xl, yh, yl)
    assert (_join(hh, hl) == prod >> 64).all()


def test_add_sub_ge_64(rng):
    x = rng.integers(0, 1 << 64, size=500, dtype=np.uint64)
    y = rng.integers(0, 1 << 64, size=500, dtype=np.uint64)
    xh, xl = _pairs(x)
    yh, yl = _pairs(y)
    ah, al = wide32.add64(xh, xl, yh, yl)
    assert (_join(ah, al) == (x.astype(object) + y.astype(object)) & M64).all()
    sh, sl = wide32.sub64(xh, xl, yh, yl)
    assert (_join(sh, sl) == (x.astype(object) - y.astype(object)) & M64).all()
    ge = np.asarray(wide32.ge64(xh, xl, yh, yl))
    assert (ge == (x >= y)).all()


def _words(q: int):
    """(qh, ql, ratio_hi words, ratio_lo words) as u32 scalars."""
    rh, rl = modular.barrett_ratio(q)
    return tuple(
        np.uint32(w)
        for v in (q, rh, rl)
        for w in (v >> 32, v & 0xFFFFFFFF)
    )


def _reduce96(s2, s1, s0, q):
    return wide32.barrett_reduce96_w(s2, s1, s0, *_words(q))


@pytest.mark.parametrize("qbits", [30, 36, 44, 48])
def test_mul_u48_3w_and_sum96(rng, qbits):
    q = primes.get_prime(128, qbits)
    D = min(64, 1 << (96 - 2 * qbits))  # the whole sum stays below 2^96
    x = rng.integers(0, q, size=(D, 50), dtype=np.uint64)
    w = rng.integers(0, q, size=(D, 50), dtype=np.uint64)
    xh, xl = _pairs(x)
    wh, wl = _pairs(w)
    p2, p1, p0 = wide32.mul_u48_3w(xh, xl, wh, wl)
    prod = x.astype(object) * w.astype(object)
    got = (
        np.asarray(p2).astype(object) << 64
    ) + (np.asarray(p1).astype(object) << 32) + np.asarray(p0).astype(object)
    assert (got == prod).all()

    s2, s1, s0 = wide32.sum96_over_axis(p2, p1, p0, axis=0)
    total = prod.sum(axis=0)
    gots = (
        np.asarray(s2).astype(object) << 64
    ) + (np.asarray(s1).astype(object) << 32) + np.asarray(s0).astype(object)
    assert (gots == total % (1 << 96)).all()

    bh, bl = _reduce96(s2, s1, s0, q)
    assert (_join(bh, bl) == total % q).all()


def test_barrett_reduce96_random(rng):
    q = primes.get_prime(256, 45)
    words = rng.integers(0, 1 << 32, size=(3, 4000), dtype=np.uint32)
    x2, x1, x0 = (jnp.asarray(w) for w in words)
    rh, rl = _reduce96(x2, x1, x0, q)
    vals = (
        words[0].astype(object) << 64
    ) + (words[1].astype(object) << 32) + words[2].astype(object)
    assert (_join(rh, rl) == vals % q).all()


@pytest.mark.parametrize("qbits", [28, 36, 44, 48])
def test_barrett_reduce96_extremes(qbits):
    """Word-boundary inputs: 0, q-1, q, 2^32-1 per word, 2^96-1, and the
    multiples of q next to the top of the range."""
    q = primes.get_prime(128, qbits)
    top = (1 << 96) - 1
    vals = [0, 1, q - 1, q, q + 1, (1 << 32) - 1, (1 << 64) - 1, top,
            top - top % q, top - top % q - 1, (top // q) * q - q]
    words = [[(v >> s) & 0xFFFFFFFF for v in vals] for s in (64, 32, 0)]
    x2, x1, x0 = (jnp.asarray(np.array(w, dtype=np.uint32)) for w in words)
    rh, rl = _reduce96(x2, x1, x0, q)
    assert list(_join(rh, rl)) == [v % q for v in vals]

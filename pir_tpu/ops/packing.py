"""Packed host<->device transfer of RNS polynomial arrays.

Every coefficient is < q_i, and the default modulus chains keep q_i well
under 2^48 (37 bits at N=4096, 44 at N=8192) — yet a u64 array moves
8 bytes per coefficient across the host link.  Splitting into a u32 low
word plus a u8/u16 high word moves 5-6 bytes instead, a 25-37.5% cut on
the per-request query upload and reply readback.  The join/split on the
device side is a pair of cheap elementwise casts fused into the serve
pipeline; the host side is vectorized numpy.

No reference analog (the reference never crosses a device boundary);
this is transport layout only — values are bit-identical after join.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def hi_dtype_for(moduli) -> "np.dtype | None":
    """Smallest dtype holding bits 32.. of any value < max(moduli).

    None means some modulus exceeds 48 bits and packing is not worth it
    (callers fall back to plain u64 transfers).
    """
    bits = max(int(m).bit_length() for m in moduli)
    if bits <= 32:
        # still need a hi word of zeros to keep one code path; u8 is free
        return np.dtype(np.uint8)
    if bits <= 40:
        return np.dtype(np.uint8)
    if bits <= 48:
        return np.dtype(np.uint16)
    return None


def split_host(a: np.ndarray, hi_dtype) -> tuple[np.ndarray, np.ndarray]:
    """u64 array -> (u32 lo, hi_dtype hi) for upload."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    lo = (a & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (a >> np.uint64(32)).astype(hi_dtype)
    return lo, hi


def join_host(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(u32 lo, any-uint hi) -> u64, after download."""
    return np.asarray(lo, dtype=np.uint64) | (
        np.asarray(hi, dtype=np.uint64) << np.uint64(32)
    )


def split_device(x: jnp.ndarray, hi_dtype) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Device-side split (end of a jitted pipeline, before download)."""
    lo = (x & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    hi = (x >> jnp.uint64(32)).astype(jnp.dtype(hi_dtype))
    return lo, hi


def join_device(lo: jnp.ndarray, hi: jnp.ndarray) -> jnp.ndarray:
    """Device-side join (start of a jitted pipeline, after upload)."""
    return lo.astype(jnp.uint64) | (hi.astype(jnp.uint64) << jnp.uint64(32))

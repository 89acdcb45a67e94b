"""Pallas (Triton route) kernel for the inner DB-scan contraction.

Same arithmetic as scan.contract_dim — exact 128-bit column sums of the
raw products, one Barrett reduction per output — written as one GPU
program per (prefix, N tile).  The contraction axis is a loop inside the
program (GPU blocks run in no order, so nothing can carry across the
grid), and the limb and ciphertext-component axes are unrolled.  The
database is read in its natural u64[P, D, L, N] layout: each step of the
loop loads one contiguous N tile per limb.

Moduli must be below 2^48 so that a whole contraction of up to 2^14
products fits the column sums without an intermediate reduction.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from pir_tpu.ops import modular

_M32 = np.uint64(0xFFFFFFFF)
_S32 = np.uint64(32)
# Warps per program.  At the 1M inner shape on an H100, 4 warps with
# 256-column tiles beat 4 or 8 warps with 512-column tiles (PERF.md).
_NUM_WARPS = 4


def supported(moduli, depth: int) -> bool:
    bits = max(int(q).bit_length() for q in moduli)
    return bits <= 48 and depth <= (1 << (62 - bits))


@functools.partial(
    jax.jit, static_argnames=("moduli", "block_n", "interpret")
)
def contract_dim(
    sv_ntt,
    items_ntt,
    moduli: tuple,
    block_n: int = 256,
    interpret: bool = False,
):
    """sv u64[D, 2, L, N] x items u64[P, D, L, N] -> u64[P, 2, L, N]."""
    D, two, L, N = sv_ntt.shape
    P = items_ntt.shape[0]
    assert two == 2 and items_ntt.shape == (P, D, L, N)
    assert len(moduli) == L and N % block_n == 0
    if not supported(moduli, D):
        raise ValueError("moduli too wide for the single-pass column sums")
    consts = [
        tuple(np.uint64(v) for v in (q, *modular.barrett_ratio(q)))
        for q in moduli
    ]

    def kernel(sv_ref, db_ref, o_ref):
        p = pl.program_id(0)
        cols = pl.ds(pl.program_id(1) * block_n, block_n)
        zero = jnp.zeros((block_n,), jnp.uint64)
        for limb in range(L):

            def body(d, accs, limb=limb):
                w = db_ref[p, d, limb, cols]
                w0 = w & _M32
                w1 = w >> _S32
                out = []
                for c in range(2):
                    x = sv_ref[d, c, limb, cols]
                    x0 = x & _M32
                    x1 = x >> _S32
                    ll = x0 * w0
                    s0, s1, s2 = accs[3 * c : 3 * c + 3]
                    out += [
                        s0 + (ll & _M32),
                        s1 + (ll >> _S32) + x0 * w1 + x1 * w0,
                        s2 + x1 * w1,
                    ]
                return tuple(out)

            accs = jax.lax.fori_loop(0, D, body, (zero,) * 6)
            q, rh, rl = consts[limb]
            for c in range(2):
                s0, s1, s2 = accs[3 * c : 3 * c + 3]
                lo = s0 + (s1 << _S32)
                hi = s2 + (s1 >> _S32) + (lo < s0).astype(jnp.uint64)
                o_ref[p, c, limb, cols] = modular.barrett_reduce_128(
                    hi, lo, q, rh, rl
                )

    return pl.pallas_call(
        kernel,
        grid=(P, N // block_n),
        out_shape=jax.ShapeDtypeStruct((P, 2, L, N), jnp.uint64),
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        backend="triton",
        name="pir_scan_contract",
    )(sv_ntt, items_ntt)

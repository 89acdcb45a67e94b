"""Negacyclic number-theoretic transform, batched over RNS limbs.

Replacement for SEAL's ``transform_to/from_ntt_inplace`` (reference call
sites: pir/cpp/database.cpp:74,104,190,226,252) — the transform behind
every key switch of oblivious expansion and every scan level.

Design: the classic merged-twiddle radix-2 formulation (Longa–Naehrig
style).  The forward transform is decimation-in-time over ψ-power twiddles
stored in bit-reversed order, producing NTT values in bit-reversed order;
the inverse (Gentleman–Sande) consumes that order and returns natural
coefficient order.  Because bit-reversed order is consistent between the
two, *no* explicit permutation is ever materialized, and pointwise
ciphertext×plaintext products are order-agnostic.  The stage loop is a
static Python loop (log2 N stages), each stage a fully vectorized
reshape + butterfly over ``[..., L, N]`` arrays — XLA sees log2(N) fused
elementwise passes with constant twiddle operands (Shoup-precomputed).

Layout contract used everywhere in this package:
  * polynomial arrays are ``uint64[..., L, N]`` — limb axis second-to-last;
  * "NTT form" means bit-reversed-order evaluations at odd powers of ψ.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from pir_tpu.core import primes as primes_mod
from pir_tpu.ops import modular


def _bit_reverse_indices(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint64)
    out = np.zeros(n, dtype=np.uint64)
    for b in range(logn):
        out |= ((idx >> b) & 1) << (logn - 1 - b)
    return out


class NttTables:
    """Precomputed twiddle tables for a list of NTT-friendly primes.

    Tables have shape [L, N]; all scalar companions are [L, 1] so they
    broadcast over ``[..., L, N]`` operands.
    """

    def __init__(self, moduli, n: int):
        self.n = n
        self.moduli = tuple(int(m) for m in moduli)
        self.limbs = modular.LimbConstants(self.moduli)
        L = len(self.moduli)
        brv = _bit_reverse_indices(n)

        psi_rev = np.zeros((L, n), dtype=np.uint64)
        psi_inv_rev = np.zeros((L, n), dtype=np.uint64)
        n_inv = np.zeros((L, 1), dtype=np.uint64)
        for li, q in enumerate(self.moduli):
            psi = primes_mod.primitive_root_2n(q, 2 * n)
            psi_inv = pow(psi, -1, q)
            powers = np.zeros(n, dtype=object)
            inv_powers = np.zeros(n, dtype=object)
            acc = 1
            acc_inv = 1
            for i in range(n):
                powers[i] = acc
                inv_powers[i] = acc_inv
                acc = acc * psi % q
                acc_inv = acc_inv * psi_inv % q
            psi_rev[li] = powers[brv.astype(np.int64)].astype(np.uint64)
            psi_inv_rev[li] = inv_powers[brv.astype(np.int64)].astype(np.uint64)
            n_inv[li, 0] = pow(n, -1, q)

        q_col = self.limbs.q  # [L, 1]
        self.psi_rev = psi_rev
        self.psi_rev_shoup = modular.shoup_precompute(psi_rev, q_col)
        self.psi_inv_rev = psi_inv_rev
        self.psi_inv_rev_shoup = modular.shoup_precompute(psi_inv_rev, q_col)
        self.n_inv = n_inv
        self.n_inv_shoup = modular.shoup_precompute(n_inv, q_col)

    def slice(self, count: int) -> "NttTables":
        """Tables restricted to the first `count` limbs (shares arrays)."""
        out = object.__new__(NttTables)
        out.n = self.n
        out.moduli = self.moduli[:count]
        out.limbs = self.limbs.slice(count)
        out.psi_rev = self.psi_rev[:count]
        out.psi_rev_shoup = self.psi_rev_shoup[:count]
        out.psi_inv_rev = self.psi_inv_rev[:count]
        out.psi_inv_rev_shoup = self.psi_inv_rev_shoup[:count]
        out.n_inv = self.n_inv[:count]
        out.n_inv_shoup = self.n_inv_shoup[:count]
        return out

    # ------------------------------------------------------------------
    def forward(self, x: jnp.ndarray) -> jnp.ndarray:
        """Coefficient order -> bit-reversed NTT order.  x: u64[..., L, N]."""
        n = self.n
        L = len(self.moduli)
        q = self.limbs.q  # [L, 1] -> broadcast below as [L, 1, 1]
        q3 = q[:, :, None]
        batch = x.shape[:-2]
        m = 1
        while m < n:
            t = n // (2 * m)
            xr = x.reshape(*batch, L, m, 2, t)
            u = xr[..., 0, :]
            v = xr[..., 1, :]
            s = self.psi_rev[:, m : 2 * m, None]  # [L, m, 1]
            s_sh = self.psi_rev_shoup[:, m : 2 * m, None]
            vs = modular.mul_mod_shoup(v, s, s_sh, q3)
            nu = modular.add_mod(u, vs, q3)
            nv = modular.sub_mod(u, vs, q3)
            x = jnp.stack([nu, nv], axis=-2).reshape(*batch, L, n)
            m *= 2
        return x

    def inverse(self, x: jnp.ndarray) -> jnp.ndarray:
        """Bit-reversed NTT order -> coefficient order.  x: u64[..., L, N]."""
        n = self.n
        L = len(self.moduli)
        q = self.limbs.q
        q3 = q[:, :, None]
        batch = x.shape[:-2]
        t = 1
        m = n
        while m > 1:
            h = m // 2
            xr = x.reshape(*batch, L, h, 2, t)
            u = xr[..., 0, :]
            v = xr[..., 1, :]
            s = self.psi_inv_rev[:, h : 2 * h, None]
            s_sh = self.psi_inv_rev_shoup[:, h : 2 * h, None]
            nu = modular.add_mod(u, v, q3)
            nv = modular.mul_mod_shoup(modular.sub_mod(u, v, q3), s, s_sh, q3)
            x = jnp.stack([nu, nv], axis=-2).reshape(*batch, L, n)
            t *= 2
            m = h
        return modular.mul_mod_shoup(x, self.n_inv, self.n_inv_shoup, q)

    # ------------------------------------------------------------------
    def pointwise_mul(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """Product of two NTT-form polynomials (any broadcastable shapes)."""
        return self.limbs.mul(a, b)

    def negacyclic_polymul(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """Full coefficient-domain negacyclic product a*b mod (x^N + 1)."""
        return self.inverse(self.pointwise_mul(self.forward(a), self.forward(b)))

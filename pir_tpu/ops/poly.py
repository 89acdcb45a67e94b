"""Coefficient-domain polynomial permutation ops: Galois automorphisms and
negacyclic monomial shifts.

These replace ``seal::util::apply_galois`` and
``seal::util::negacyclic_shift_poly_coeffmod`` (reference call sites:
pir/cpp/server.cpp:67-103).  Both are sign-flipping permutations of the
coefficient axis; they lower to a gather plus a select — cheap
compared to the key-switch that follows (the reference notes the ~20x cost
ratio at pir/cpp/server.cpp:134-136).
"""

from __future__ import annotations

import jax.numpy as jnp

from pir_tpu.ops import modular


def apply_signed_permutation(x: jnp.ndarray, src, flip, q) -> jnp.ndarray:
    """out[..., k] = ±x[..., src[k]], negating (mod q) where flip[k].

    x: u64[..., L, N]; src: int32[N]; flip: bool[N]; q broadcastable [L, 1].
    """
    gathered = jnp.take(x, jnp.asarray(src), axis=-1)
    return jnp.where(jnp.asarray(flip), modular.neg_mod(gathered, q), gathered)


def galois_transform(ctx, x: jnp.ndarray, galois_elt: int) -> jnp.ndarray:
    """x(x^galois_elt) mod (x^N+1) on coefficient-form limbs [..., L, N]."""
    src, flip = ctx.galois_permutation(galois_elt)
    return apply_signed_permutation(x, src, flip, ctx.limbs_q.q)


def monomial_shift(ctx, x: jnp.ndarray, index: int) -> jnp.ndarray:
    """x * x^index mod (x^N+1), index in [0, 2N) (static per call site)."""
    src, flip = ctx.monomial_shift_permutation(index)
    return apply_signed_permutation(x, src, flip, ctx.limbs_q.q)


def multiply_inverse_power_of_x(ctx, ct: jnp.ndarray, k: int) -> jnp.ndarray:
    """ct * x^{-k}: the expansion helper of pir/cpp/server.cpp:78-103.

    Implemented as the negacyclic shift by index (2N - k) mod 2N, applied to
    every polynomial and limb of the ciphertext.
    """
    index = (2 * ctx.n - k) % (2 * ctx.n)
    return monomial_shift(ctx, ct, index)

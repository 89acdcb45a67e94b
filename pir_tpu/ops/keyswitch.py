"""Key switching: the kernel behind Galois automorphisms and relinearization.

Replaces ``seal::Evaluator::apply_galois_inplace`` /
``relinearize_inplace`` (reference call sites pir/cpp/server.cpp:71,
pir/cpp/database.cpp:209) — the dominant cost of oblivious query expansion
(the reference notes its ~20x cost over the shift op, server.cpp:134-136).

Pipeline for input polynomial c (coefficient form, ciphertext level q):

1. RNS-decompose: digit i is just limb i of c, viewed in [0, q_i) and
   re-reduced modulo every key-level prime — [..., L, Lp, N].
2. Forward NTT over the key chain QP.
3. Inner product with the switch key: acc_k = Σ_i digit_i ⊙ ksk[i, k].
4. Inverse NTT, then exact scale-down by the special prime P with centered
   rounding: out_j = (acc_j - center(acc mod P)) · P⁻¹ mod q_j.

The whole pipeline is batched over arbitrary leading axes — oblivious
expansion feeds it 2^j ciphertexts at level j in one call.

Limb sharding (parallel/sharded.py): when ``ctx`` is a per-shard view with
``limb_axis_name`` set, the input carries only this device's RNS limbs and
the key carries only the matching decomposition rows; the digit inner
product's sum then becomes a local partial plus one ``psum`` over the limb
mesh axis (the only cross-limb exchange in the whole protocol), and the
full-basis tail (INTT over QP + P scale-down) runs replicated before each
device keeps its own limb slice via ``ctx.take_ct_limbs``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

import numpy as np

from pir_tpu.core.context import PirContext
from pir_tpu.ops import modular, poly, wide32


def _qp_words(qp):
    """LimbConstants -> six u32[Lp, 1] word columns (qh, ql, rhh, rhl,
    rlh, rll) for the 96-bit Barrett reduction (wide32.barrett_reduce96_w).
    Host-side numpy; broadcasts over [..., Lp, N] operands."""
    out = []
    for arr in (qp.q, qp.ratio_hi, qp.ratio_lo):
        a = np.asarray(arr)
        out.append((a >> np.uint64(32)).astype(np.uint32))
        out.append((a & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return tuple(out)


def _digit_inner_product(ctx, digits, data, qp):
    """acc[k] = Σ_i digits[i] ⊙ ksk[i, k] over the decomposition axis,
    reduced mod every key prime — the key switch's hot contraction.

    digits: u64[..., L, Lp, N] NTT form; data: u64[L, 2, Lp, N].
    Returns reduced u64[..., 2, Lp, N], including the cross-shard psum on
    limb-sharded meshes.

    Three arithmetic strategies, chosen statically from the modulus widths
    (the same raw-accumulation idea as the DB scan, ops/scan.py):

    * **u32 raw (4-mul)** — every key prime below 2^31 and the whole digit
      sum exact in u64 (L_total·q² < 2^64): one 32x32->64 product per MAC
      (wide32.mul32_wide) accumulated with plain u64 adds, ONE Barrett
      reduction per output element (the sub-32-bit "tpu32" parameter
      profile's chains).
    * **48-bit raw (9-mul)** — primes below 2^48 (the SEAL default chain's
      36/37-bit primes): three-word raw products (wide32.mul_u48_3w) with
      exact 16-bit-half partial sums over the digit axis and one 96-bit
      Barrett reduction per output.
    * **generic** — any chain up to 61 bits: full 128-bit Barrett per MAC
      (the bit-exactness reference; also the only path with headroom for
      arbitrary big chains).
    """
    L_total = len(ctx.ct_moduli)  # full decomposition count (all shards)
    moduli = tuple(int(m) for m in qp.moduli)
    bits = max(m.bit_length() for m in moduli)
    limb_axis = getattr(ctx, "limb_axis_name", None)
    x = digits[..., :, None, :, :]  # [..., L, 1, Lp, N]

    if bits <= 31 and L_total * (max(moduli) - 1) ** 2 < (1 << 64):
        prod = wide32.join_u64(
            *wide32.mul32_wide(
                x.astype(jnp.uint32), data.astype(jnp.uint32)
            )
        )
        tot = jnp.sum(prod, axis=-4)  # exact: L_total·q² < 2^64
        if limb_axis is not None:
            tot = jax.lax.psum(tot, limb_axis)
        return modular.barrett_reduce_64(tot, qp.q, qp.ratio_hi)

    if bits <= 48 and L_total < (1 << 16):
        xh, xl = wide32.split_u64(x)
        wh, wl = wide32.split_u64(data)
        p2, p1, p0 = wide32.mul_u48_3w(xh, xl, wh, wl)
        s2, s1, s0 = wide32.sum96_over_axis(
            p2, p1, p0, axis=-4, p2_max_bits=max(0, 2 * bits - 64)
        )
        tot = wide32.join_u64(
            *wide32.barrett_reduce96_w(s2, s1, s0, *_qp_words(qp))
        )
        if limb_axis is not None:
            # per-shard totals are already reduced (< q < 2^48): the psum
            # of S shards stays u64-exact, one final reduction closes it
            tot = jax.lax.psum(tot, limb_axis)
            tot = modular.barrett_reduce_64(tot, qp.q, qp.ratio_hi)
        return tot

    prod = modular.mul_mod(x, data, qp.q, qp.ratio_hi, qp.ratio_lo)
    # Reduced summands (< q_j < 2^61); L terms fit u64 without wrap.
    tot = jnp.sum(prod, axis=-4)
    if limb_axis is not None:
        # limb-sharded: local digits only — complete the digit sum across
        # the limb mesh axis (u64-exact: reduced summands, L·q < 2^64)
        tot = jax.lax.psum(tot, limb_axis)
    return modular.barrett_reduce_64(tot, qp.q, qp.ratio_hi)


def switch_key(ctx: PirContext, ksk, c: jnp.ndarray):
    """Key-switch c (u64[..., L, N] coeff form) -> (out0, out1) same shape.

    Adding (out0, out1) to a ciphertext replaces a term c·t_key with its
    encryption under s, where t_key is the switch key's target.
    """
    qp = ctx.limbs_qp
    # accept either a KSwitchKey or its raw [L, 2, Lp, N] array (jit pytrees)
    data = getattr(ksk, "data", ksk)

    # 1. decompose: limb i of c broadcast to all Lp key primes.  The input
    # limbs are reduced (< q_i), so when every ct modulus is within a few
    # bits of every key prime — true for both built-in chains — the
    # re-reduction is a couple of shift-compare-subtract steps instead of
    # a Barrett multiply (same trick as SEAL's modulo_poly_coeffs fast
    # path; ~20 u32 ops saved per element on the expansion hot path).
    ct_bits = max(int(m).bit_length() for m in ctx.ct_moduli)
    k_max = ((1 << ct_bits) - 1) // min(int(m) for m in qp.moduli)
    x = c[..., :, None, :]  # [..., L, 1, N] vs q_col [Lp, 1]
    if k_max <= 4:
        digits = jnp.broadcast_to(
            x, x.shape[:-2] + (len(qp.moduli), x.shape[-1])
        )
        for i in range(k_max.bit_length() - 1, -1, -1):
            s = qp.q << np.uint64(i)
            digits = jnp.where(digits >= s, digits - s, digits)
    else:
        digits = modular.barrett_reduce_64(x, qp.q, qp.ratio_hi)
    # digits: [..., L, Lp, N]

    # 2. NTT over QP (limb axis is second-to-last).
    digits = ctx.ntt_qp.forward(digits)

    # 3. inner product with the key: [..., L, 1, Lp, N] x [L, 2, Lp, N].
    acc = _digit_inner_product(ctx, digits, data, qp)  # [..., 2, Lp, N]

    # 4. INTT and scale down by P with centered rounding.
    acc = ctx.ntt_qp.inverse(acc)
    t_last = acc[..., ctx.Lp - 1 : ctx.Lp, :]  # [..., 2, 1, N], mod P
    p = jnp.uint64(int(ctx.special))
    u = t_last + ctx.p_half_u64
    u = jnp.where(u >= p, u - p, u)
    lq = ctx.limbs_q
    u_mod_q = modular.barrett_reduce_64(u, lq.q, lq.ratio_hi)  # [..., 2, L, N]
    t_bar = modular.sub_mod(u_mod_q, ctx.p_half_mod_q, lq.q)
    out = modular.mul_mod_shoup(
        modular.sub_mod(ctx.take_ct_limbs(acc), t_bar, lq.q),
        ctx.p_inv_mod_q,
        ctx.p_inv_mod_q_shoup,
        lq.q,
    )
    return out[..., 0, :, :], out[..., 1, :, :]


def apply_galois(ctx: PirContext, galois_keys, ct: jnp.ndarray, galois_elt: int):
    """Substitution operator x -> x^galois_elt on a ciphertext.

    ct: u64[..., 2, L, N] coefficient form.  Semantics of
    PIRServer::substitute_power_x_inplace (pir/cpp/server.cpp:67-76).
    """
    key = galois_keys[galois_elt]
    key = getattr(key, "data", key)  # raw array for the jit boundary

    def build():
        def run(c, k):
            c0 = poly.galois_transform(ctx, c[..., 0, :, :], galois_elt)
            c1 = poly.galois_transform(ctx, c[..., 1, :, :], galois_elt)
            k0, k1 = switch_key(ctx, k, c1)
            return jnp.stack(
                [modular.add_mod(c0, k0, ctx.limbs_q.q), k1], axis=-3
            )

        return run

    return ctx.maybe_jitted(f"apply_galois_{galois_elt}", build, ct, key)


def relinearize(ctx: PirContext, relin_keys, ct3: jnp.ndarray) -> jnp.ndarray:
    """Size-3 -> size-2 ciphertext using the s² switch key.

    ct3: u64[..., 3, L, N] coefficient form (output of ct×ct multiply).
    """
    key = getattr(relin_keys, "key", relin_keys)
    k0, k1 = switch_key(ctx, key, ct3[..., 2, :, :])
    q = ctx.limbs_q.q
    return jnp.stack(
        [
            modular.add_mod(ct3[..., 0, :, :], k0, q),
            modular.add_mod(ct3[..., 1, :, :], k1, q),
        ],
        axis=-3,
    )

"""Oblivious query expansion (Angel et al., SealPIR).

Turns one ciphertext encrypting a packed one-hot polynomial into m
ciphertexts, the k-th encrypting coefficient k (scaled by
next_power_two(m) — the client pre-cancels this with an m⁻¹ factor).

Parity with PIRServer::oblivious_expansion (pir/cpp/server.cpp:105-171),
with the reference's sequencing trick preserved: the substitution operator
runs once per input ciphertext per level, and the "c1" shift is applied
*after* substitution with index N + 2^j (server.cpp:129-138).

Shape: the 2^j ciphertexts at level j are a single batched tensor
[2^j, 2, L, N]; each level is one batched apply_galois (the
dominant key-switch matmul-like kernel) plus two sign-permutation gathers
and two adds.  The level loop is static (log2 m iterations).
"""

from __future__ import annotations

import jax.numpy as jnp

from pir_tpu.core.context import PirContext
from pir_tpu.ops import keyswitch, modular, poly
from pir_tpu.utils.math import ceil_log2, next_power_two


def expand_level(
    ctx: PirContext, galois_keys, cts: jnp.ndarray, j: int, axis: int = 0
) -> jnp.ndarray:
    """One doubling level of oblivious expansion: u64[B, 2, L, N] ->
    u64[2B, 2, L, N] (level j uses Galois element N/2^j + 1;
    server.cpp:120-143).  Exposed separately so the server can jit each
    level as its own executable — per-level compiles are small and run
    concurrently, which bounds pipeline warmup (compile time in XLA grows
    superlinearly with HLO size).

    axis: which axis doubles — batched serving runs Q independent trees
    as u64[Q, B, 2, L, N] with axis=1 (every op here is batched over
    leading axes, so the level body is identical)."""
    n = ctx.n
    q = ctx.limbs_q.q
    galois_elt = (n >> j) + 1
    sub = keyswitch.apply_galois(ctx, galois_keys, cts, galois_elt)
    # new upper half: c·x^{-2^j} + Sub(c)·x^{-(N+2^j)}
    lower = modular.add_mod(
        poly.multiply_inverse_power_of_x(ctx, cts, 1 << j),
        poly.multiply_inverse_power_of_x(ctx, sub, n + (1 << j)),
        q,
    )
    upper = modular.add_mod(cts, sub, q)
    return jnp.concatenate([upper, lower], axis=axis)


def expand_single(
    ctx: PirContext, galois_keys, ct: jnp.ndarray, num_items: int
) -> jnp.ndarray:
    """Expand one ciphertext u64[2, L, N] into u64[num_items, 2, L, N].

    num_items == 0 yields an empty batch (the reference's degenerate last
    query ciphertext when dim_sum is an exact multiple of N).
    """
    n = ctx.n
    if num_items > n:
        raise ValueError("cannot expand more items from a CT than poly degree")
    if num_items == 0:
        return ct[jnp.newaxis][:0]

    def build():
        def run(c, gk):
            logm = ceil_log2(num_items)
            cts = c[jnp.newaxis]  # [1, 2, L, N]
            for j in range(logm):
                cts = expand_level(ctx, gk, cts, j)
            assert cts.shape[0] == next_power_two(num_items)
            return cts[:num_items]

        return run

    return ctx.maybe_jitted(
        f"expand_single_{num_items}", build, ct, galois_keys
    )


def expand_single_sharded(
    ctx: PirContext,
    galois_keys,
    ct: jnp.ndarray,
    num_items: int,
    axis_name: str,
    n_shards: int,
) -> jnp.ndarray:
    """expand_single with the doubling tree sharded over a mesh axis.

    The expansion tree is position-independent: level j maps ct k to
    outputs (k, k + 2^j) using only ct k, so after log2(S) replicated
    levels each of the S shards can continue expanding its own subtree —
    shard s's local output m is global output s + m*S — with zero
    cross-shard traffic until one final all_gather + stride-unshuffle.
    This removes the round-3 bottleneck of every db shard redundantly
    computing the full key-switch expansion (the scan analog of
    pir/cpp/server.cpp:105-146): key-switch applications per shard drop
    from 2^logm - 1 to (S - 1) + (2^logm - S)/S.

    Bit-exact with expand_single (identical ops, reordered across
    devices).  Callable only inside shard_map with `axis_name` bound.
    """
    import jax

    n = ctx.n
    if num_items > n:
        raise ValueError("cannot expand more items from a CT than poly degree")
    logm = ceil_log2(num_items)
    if n_shards <= 1 or n_shards & (n_shards - 1) or (1 << logm) <= n_shards:
        # non-power-of-two shard counts and tiny trees: replicate (cheap)
        return expand_single(ctx, galois_keys, ct, num_items)
    j0 = n_shards.bit_length() - 1  # log2(S)
    cts = ct[jnp.newaxis]
    for j in range(j0):
        cts = expand_level(ctx, galois_keys, cts, j)  # replicated: S cts
    mine = jax.lax.dynamic_slice_in_dim(
        cts, jax.lax.axis_index(axis_name), 1, axis=0
    )
    for j in range(j0, logm):
        mine = expand_level(ctx, galois_keys, mine, j)
    # mine[m] is global output s + m*S; gather and unshuffle the stride
    full = jax.lax.all_gather(mine, axis_name, axis=0)  # [S, M, 2, L, N]
    m_local = mine.shape[0]
    out = jnp.transpose(full, (1, 0, 2, 3, 4)).reshape(
        n_shards * m_local, *mine.shape[1:]
    )
    assert out.shape[0] == next_power_two(num_items)
    return out[:num_items]


def expand_query_sharded(
    ctx: PirContext,
    galois_keys,
    cts: jnp.ndarray,
    total_items: int,
    axis_name: str,
    n_shards: int,
) -> jnp.ndarray:
    """expand_query with each ciphertext's tree sharded (see above)."""
    n = ctx.n
    if cts.shape[0] != total_items // n + 1:
        raise ValueError(
            "number of ciphertexts doesn't match number of items for "
            "oblivious expansion"
        )
    outs = []
    remaining = total_items
    for i in range(cts.shape[0]):
        count = min(n, remaining)
        if count > 0:
            outs.append(
                expand_single_sharded(
                    ctx, galois_keys, cts[i], count, axis_name, n_shards
                )
            )
        remaining -= n
    return jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]


def expand_single_batch(
    ctx: PirContext, galois_keys, cts: jnp.ndarray, num_items: int
) -> jnp.ndarray:
    """Expand Q independent ciphertexts u64[Q, 2, L, N] into
    u64[Q, num_items, 2, L, N] — one fused doubling tree per query, all
    queries sharing each level's (batched) key-switch kernel.  Bit-exact
    per lane with expand_single (identical ops, the doubling axis simply
    carries a leading query axis)."""
    n = ctx.n
    if num_items > n:
        raise ValueError("cannot expand more items from a CT than poly degree")
    if num_items == 0:
        return cts[:, None][:, :0]

    def build():
        def run(c, gk):
            logm = ceil_log2(num_items)
            x = c[:, None]  # [Q, 1, 2, L, N]
            for j in range(logm):
                x = expand_level(ctx, gk, x, j, axis=1)
            assert x.shape[1] == next_power_two(num_items)
            return x[:, :num_items]

        return run

    return ctx.maybe_jitted(
        f"expand_single_batch_{num_items}_{cts.shape[0]}", build, cts, galois_keys
    )


def expand_query_batch(
    ctx: PirContext, galois_keys, cts: jnp.ndarray, total_items: int
) -> jnp.ndarray:
    """Expand Q same-shape queries u64[Q, num_cts, 2, L, N] into
    u64[Q, total_items, 2, L, N] (the batched twin of expand_query)."""
    n = ctx.n
    if cts.shape[1] != total_items // n + 1:
        raise ValueError(
            "number of ciphertexts doesn't match number of items for "
            "oblivious expansion"
        )
    outs = []
    remaining = total_items
    for i in range(cts.shape[1]):
        count = min(n, remaining)
        if count > 0:
            outs.append(
                expand_single_batch(ctx, galois_keys, cts[:, i], count)
            )
        remaining -= n
    return jnp.concatenate(outs, axis=1) if len(outs) > 1 else outs[0]


def expand_query(
    ctx: PirContext, galois_keys, cts: jnp.ndarray, total_items: int
) -> jnp.ndarray:
    """Expand a multi-ciphertext query into total_items selection ciphertexts.

    cts: u64[num_cts, 2, L, N] with num_cts == total_items // N + 1
    (parity with server.cpp:148-171, including the degenerate extra
    ciphertext when total_items is an exact multiple of N).
    """
    n = ctx.n
    if cts.shape[0] != total_items // n + 1:
        raise ValueError(
            "number of ciphertexts doesn't match number of items for "
            "oblivious expansion"
        )
    outs = []
    remaining = total_items
    for i in range(cts.shape[0]):
        count = min(n, remaining)
        outs.append(expand_single(ctx, galois_keys, cts[i], count))
        remaining -= n
    return jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]

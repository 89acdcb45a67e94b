"""The ciphertext×database scan — the server's matmul-like hot kernel.

Computes the recursive hypercube dot product of the reference's
DatabaseMultiplier (pir/cpp/database.cpp:118-288), reformulated as dense
tensor contractions:

* the database is a dense, zero-padded hypercube of NTT-form plaintext
  polynomials (zero padding is mathematically identical to the reference's
  early-break iterator — missing terms contribute exact zeros);
* the innermost dimension is one batched modular
  multiply-accumulate contraction over all prefixes at once;
* upper dimensions decompose intermediate ciphertexts into digit
  plaintexts (ops/decompose.py) and contract again;
* products are accumulated unreduced in exact 128-bit column sums
  (modular.sum_products_128) and reduced once per output, so a contraction
  is one fused multiply-reduce over the 8-byte-per-coefficient database.

Everything is jittable with static shapes; the leading "prefix" axis is
the natural sharding axis for the multi-chip path (parallel/).
"""

from __future__ import annotations

import jax.numpy as jnp

from pir_tpu.core.context import PirContext
from pir_tpu.ops import decompose, modular


def _max_chunk(ctx: PirContext) -> int:
    """How many reduced summands fit in u64 before a reduction is needed."""
    maxq_bits = max(q.bit_length() for q in ctx.ct_moduli)
    return max(1, 1 << (63 - maxq_bits))


def _raw_chunk(ctx: PirContext) -> int:
    """How many unreduced products one 128-bit column sum may hold
    (modular.sum_products_128): 2^(62-b) for b-bit moduli."""
    maxq_bits = max(int(q).bit_length() for q in ctx.ct_moduli)
    return 1 << max(0, 62 - maxq_bits)


def _on_gpu() -> bool:
    """Whether the trace in progress targets a GPU (honours
    jax.default_device scopes)."""
    import jax

    dev = jax.config.jax_default_device
    platform = dev.platform if dev is not None else jax.default_backend()
    return platform == "gpu"


def _gpu_kernel_applies(ctx: PirContext, depth: int, n: int) -> bool:
    """The Triton kernel needs host-constant moduli (not a limb-sharded
    view's traced slices), moduli below 2^48 and a power-of-two N."""
    from pir_tpu.ops import scan_triton

    return (
        _on_gpu()
        and getattr(ctx, "limb_axis_name", None) is None
        and n & (n - 1) == 0
        and scan_triton.supported(ctx.ct_moduli, depth)
    )


def contract_dim(
    ctx: PirContext,
    sv_ntt: jnp.ndarray,
    items_ntt: jnp.ndarray,
) -> jnp.ndarray:
    """acc[p, ...] = Σ_j sv[j] ⊙ items[p, j, ...]  (NTT domain, mod q).

    sv_ntt:    u64[D, 2, L, N]   — selection-vector ciphertexts, NTT form
    items_ntt: u64[P, D, L, N]   — plaintext polys per prefix p and index j
    returns    u64[P, 2, L, N]

    Raw accumulation: the D products of each output are summed exactly
    (modular.sum_products_128) and reduced by one Barrett reduction, so the
    database is read at 8 bytes per coefficient with no per-product
    reduction and no precomputed companion table.  On a GPU the same
    arithmetic runs as one Triton kernel (ops/scan_triton.py), which reads
    the database at close to the memory bandwidth; elsewhere it is the
    plain XLA form below, which is also the kernel's reference.  The
    plain form, about 11x slower at the 1M shape, also runs on the GPU
    where the kernel does not apply: limb-sharded meshes (traced per-shard
    moduli) and moduli of 2^48 or wider.
    """
    D, n = items_ntt.shape[1], items_ntt.shape[-1]
    if _gpu_kernel_applies(ctx, D, n):
        from pir_tpu.ops import scan_triton

        return scan_triton.contract_dim(
            sv_ntt, items_ntt, tuple(int(q) for q in ctx.ct_moduli),
            block_n=min(256, n),
        )
    lq = ctx.limbs_q
    chunk = min(_raw_chunk(ctx), D)
    acc = None
    for start in range(0, D, chunk):
        end = min(start + chunk, D)
        hi, lo = modular.sum_products_128(
            sv_ntt[None, start:end],  # [1, c, 2, L, N]
            items_ntt[:, start:end, None],  # [P, c, 1, L, N]
            axis=1,
        )
        part = modular.barrett_reduce_128(
            hi, lo, lq.q, lq.ratio_hi, lq.ratio_lo
        )
        acc = part if acc is None else modular.add_mod(acc, part, lq.q)
    return acc


def database_scan_decomp(
    ctx: PirContext,
    db_ntt: jnp.ndarray,
    dims: tuple,
    sv_ntt: jnp.ndarray,
    probe=None,
) -> jnp.ndarray:
    """Full d-dimensional decomposition-mode scan.

    db_ntt: u64[prod(dims), L, N] — zero-padded DB plaintexts in NTT form.
    dims:   hypercube dimensions (D_0, ..., D_{d-1}); DB index is row-major
            with D_0 outermost (parity with database.cpp:318-326).
    sv_ntt: u64[sum(dims), 2, L, N] — expanded selection vector, NTT form,
            dimension blocks concatenated in order.
    Returns u64[(2·ER)^(d-1), 2, L, N] reply ciphertexts, coefficient form.
    """
    d = len(dims)
    offsets = []
    off = 0
    for dim in dims:
        offsets.append(off)
        off += dim
    total = 1
    for dim in dims:
        total *= dim
    if db_ntt.shape[0] != total:
        raise ValueError("database must be zero-padded to the hypercube")

    # Innermost dimension: plain DB plaintexts, one ct per prefix.
    inner = dims[-1]
    prefix = total // inner
    sv_last = sv_ntt[offsets[-1] : offsets[-1] + inner]
    items = db_ntt.reshape(prefix, inner, *db_ntt.shape[1:])
    result = contract_dim(ctx, sv_last, items)  # [prefix, 2, L, N]
    result = ctx.ntt_q.inverse(result)  # coeff form, like the reference's
    # per-level transform_from_ntt (database.cpp:250-254)
    if probe is not None:
        probe(f"dim {d - 1} (inner contraction)", result)

    # Upper dimensions, bottom-up: decompose, re-NTT, contract.
    for level in range(d - 2, -1, -1):
        dim = dims[level]
        prefix //= dim
        sv_lvl = sv_ntt[offsets[level] : offsets[level] + dim]
        # result: [prefix*dim, C, 2, L, N] (C=1 at the first upper level)
        if result.ndim == 4:
            result = result[:, None]  # add the C axis
        C = result.shape[1]
        # limb-sharded views swap in an all-gathering decomposition
        # (parallel/sharded.py) — digits live per-limb, but every digit
        # plaintext must reach every limb for the next contraction
        decomp_fn = getattr(ctx, "decompose_fn", None)
        if decomp_fn is not None:
            pts = decomp_fn(result)  # [prefix*dim, C, 2*ER, N]
        else:
            pts = decompose.decompose_ct(ctx, result)
        pts_ntt = ctx.ntt_q.forward(
            jnp.broadcast_to(
                pts[..., None, :],
                pts.shape[:-1] + (ctx.L, ctx.n),
            )
        )  # [prefix*dim, C, 2*ER, L, N]
        # flatten (lower-ct, digit) C-order: parity with the reference's
        # `for ct in lower_result: for pt in Encode(ct)` (database.cpp:217-233)
        newC = C * pts_ntt.shape[2]
        items = pts_ntt.reshape(prefix, dim, newC, ctx.L, ctx.n)
        # contract over `dim` for each of the newC digit plaintexts:
        # treat (prefix, newC) jointly as the prefix axis.
        items_flat = items.transpose(0, 2, 1, 3, 4).reshape(
            prefix * newC, dim, ctx.L, ctx.n
        )
        res = contract_dim(ctx, sv_lvl, items_flat)  # [prefix*newC, 2, L, N]
        res = ctx.ntt_q.inverse(res)
        result = res.reshape(prefix, newC, 2, ctx.L, ctx.n)
        if probe is not None:
            probe(f"dim {level} (digit contraction)", res)

    # top level: prefix == 1; C axis may be absent for d == 1
    if result.ndim == 4:
        result = result[:, None]
    return result.reshape(-1, 2, ctx.L, ctx.n)


def database_scan_ctmult(
    ctx: PirContext,
    db_ntt: jnp.ndarray,
    dims: tuple,
    sv: jnp.ndarray,
    relin_key,
) -> jnp.ndarray:
    """Ciphertext-multiplication-mode scan (database.cpp:202-211 recursion).

    sv: u64[sum(dims), 2, L, N] selection vector in **coefficient** form —
    upper dimensions consume it through the full BFV ct×ct multiply,
    relinearizing after each product.  Returns one u64[1, 2, L, N] reply.
    """
    from pir_tpu.bfv.multiply import bfv_multiply
    from pir_tpu.ops.keyswitch import relinearize

    d = len(dims)
    offsets = []
    off = 0
    for dim in dims:
        offsets.append(off)
        off += dim

    # Innermost dimension: same NTT-domain ct×pt contraction as decomp mode
    # (SEAL's multiply_plain does this NTT round trip internally).
    inner = dims[-1]
    prefix = db_ntt.shape[0] // inner
    sv_last_ntt = ctx.ntt_q.forward(sv[offsets[-1] : offsets[-1] + inner])
    items = db_ntt.reshape(prefix, inner, *db_ntt.shape[1:])
    result = ctx.ntt_q.inverse(contract_dim(ctx, sv_last_ntt, items))

    for level in range(d - 2, -1, -1):
        dim = dims[level]
        prefix //= dim
        sv_lvl = sv[offsets[level] : offsets[level] + dim]  # [dim, 2, L, N]
        blocks = result.reshape(prefix, dim, 2, ctx.L, ctx.n)
        prod3 = bfv_multiply(ctx, blocks, sv_lvl[None])  # [prefix, dim, 3, L, N]
        prod2 = relinearize(ctx, relin_key, prod3)  # [prefix, dim, 2, L, N]
        # accumulate over the dimension (reduced summands, u64 headroom)
        lq = ctx.limbs_q
        chunk = min(_max_chunk(ctx), dim)
        acc = None
        for start in range(0, dim, chunk):
            part = modular.barrett_reduce_64(
                jnp.sum(prod2[:, start : start + chunk], axis=1),
                lq.q,
                lq.ratio_hi,
            )
            acc = part if acc is None else modular.add_mod(acc, part, lq.q)
        result = acc

    return result.reshape(1, 2, ctx.L, ctx.n)

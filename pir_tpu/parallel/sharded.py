"""Multi-chip execution: expansion + DB scan sharded over a jax.sharding.Mesh.

The reference is single-threaded/single-process (SURVEY §2c); multi-chip is
a new design obligation driven by BASELINE.json.  Layout:

* mesh axis ``"db"`` — partitions the **first hypercube dimension** D0.
  Each device owns a contiguous block of DB rows (and slices the matching
  part of the first selection-vector block), so every recursion level below
  the top is embarrassingly parallel; only the top-level contraction
  crosses devices, as one homomorphic-add ``psum`` of reduced RNS limb
  arrays (u64 headroom: S·q < 2^64 for any realistic mesh size).
* mesh axis ``"batch"`` — partitions independent queries (the reference's
  serial per-query loop, server.cpp:60-63, becomes a sharded batch axis).
  Query expansion runs per batch shard, replicated across the "db" axis —
  it is ~D0× cheaper than the scan it feeds.
* mesh axis ``"limb"`` — partitions the RNS limb axis (the tensor-parallel
  analog; SURVEY §2c "RNS-limb parallelism").  Every limb-local op (NTT,
  ct×pt contraction, monomial shifts, Galois permutations) runs on the
  device's own limbs with its own twiddle/Barrett tables, shipped in as
  limb-sharded arguments.  Exactly two collectives cross the limb axis:
  (1) the key-switch digit inner product — each device contracts its own
  decomposition digits against its own key rows, then one ``psum``
  completes the sum over all limbs (ops/keyswitch.py); (2) the ciphertext
  digit decomposition between hypercube levels — digits are extracted
  per-limb, then one ``all_gather`` hands every digit plaintext to every
  limb for the next contraction.

D0 and the query batch are zero-padded to multiples of the mesh axes;
zero ciphertexts/rows are exact no-ops in every homomorphic identity, so
padded results equal the unpadded scan bit-for-bit.  The limb axis is
never padded — it must divide L exactly.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pir_tpu.core.context import PirContext
from pir_tpu.ops import decompose, expand, modular, scan
from pir_tpu.ops.modular import LimbConstants
from pir_tpu.ops.ntt import NttTables


def pad_axis(arr, axis: int, multiple: int):
    """Zero-pad `axis` up to a multiple.  numpy stays numpy (multi-process
    pipelines bake host arrays into the program as replicated constants —
    a process-local device array cannot participate in a global mesh)."""
    size = arr.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - size)
    xp = np if isinstance(arr, np.ndarray) else jnp
    return xp.pad(arr, pad)


def default_mesh(devices=None, batch: int = 1, limb: int = 1) -> Mesh:
    """Mesh over all devices: ("db", "batch"[, "limb"]) with the given widths.

    The "limb" axis is only materialized when limb > 1 (keeps the common
    db×batch layout unchanged).
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if n % (batch * limb) != 0:
        raise ValueError(
            f"device count {n} not divisible by batch*limb = {batch * limb}"
        )
    if limb > 1:
        return Mesh(
            devices.reshape(n // (batch * limb), batch, limb),
            axis_names=("db", "batch", "limb"),
        )
    return Mesh(devices.reshape(n // batch, batch), axis_names=("db", "batch"))


# ----------------------------------------------------------------------
# Limb sharding: per-shard table plumbing
# ----------------------------------------------------------------------


def _limb_tables(ctx: PirContext) -> dict:
    """All per-ct-limb constant arrays, keyed for sharding on axis 0."""
    nt = ctx.ntt_q
    tabs = {
        "psi_rev": nt.psi_rev,
        "psi_rev_shoup": nt.psi_rev_shoup,
        "psi_inv_rev": nt.psi_inv_rev,
        "psi_inv_rev_shoup": nt.psi_inv_rev_shoup,
        "n_inv": nt.n_inv,
        "n_inv_shoup": nt.n_inv_shoup,
        "q": nt.limbs.q,
        "ratio_hi": nt.limbs.ratio_hi,
        "ratio_lo": nt.limbs.ratio_lo,
    }
    if ctx.special is not None:
        tabs["p_half_mod_q"] = ctx.p_half_mod_q
        tabs["p_inv_mod_q"] = ctx.p_inv_mod_q
        tabs["p_inv_mod_q_shoup"] = ctx.p_inv_mod_q_shoup
    return tabs


class _LimbShardView:
    """A PirContext stand-in seen by one limb shard inside shard_map.

    Limb-axis tables are this device's traced slices; everything
    limb-independent (Galois/shift permutations, the full-key-basis QP
    tables used replicated inside key switching) delegates to the real
    context.  ``limb_axis_name`` being set switches ops/keyswitch.py into
    its psum form, and ``decompose_fn`` switches ops/scan.py to the
    all-gathering digit decomposition.
    """

    def __init__(self, ctx: PirContext, tabs: dict, axis_name: str):
        self._ctx = ctx
        self.limb_axis_name = axis_name
        l_local = tabs["q"].shape[0]
        self.L = l_local
        self._offset = jax.lax.axis_index(axis_name) * l_local

        nt = object.__new__(NttTables)
        nt.n = ctx.n
        # the shard's moduli are traced slices, not host ints: only len()
        # is consumed under trace
        nt.moduli = (None,) * l_local
        lim = object.__new__(LimbConstants)
        lim.moduli = nt.moduli
        lim.q = tabs["q"]
        lim.ratio_hi = tabs["ratio_hi"]
        lim.ratio_lo = tabs["ratio_lo"]
        nt.limbs = lim
        nt.psi_rev = tabs["psi_rev"]
        nt.psi_rev_shoup = tabs["psi_rev_shoup"]
        nt.psi_inv_rev = tabs["psi_inv_rev"]
        nt.psi_inv_rev_shoup = tabs["psi_inv_rev_shoup"]
        nt.n_inv = tabs["n_inv"]
        nt.n_inv_shoup = tabs["n_inv_shoup"]
        self.ntt_q = nt
        self.limbs_q = lim
        if ctx.special is not None:
            self.p_half_mod_q = tabs["p_half_mod_q"]
            self.p_inv_mod_q = tabs["p_inv_mod_q"]
            self.p_inv_mod_q_shoup = tabs["p_inv_mod_q_shoup"]

        # digit decomposition with the cross-limb all_gather (see module doc)
        ratios = decompose.local_expansion_ratios(ctx)
        max_r = max(ratios)
        # per-limb digit widths (uniform pt_bits in legacy mode, balanced
        # otherwise — ops/decompose.digit_widths); this device's slice is
        # selected by the traced shard offset
        widths_all = jnp.asarray(
            np.array(decompose.digit_widths(ctx), dtype=np.uint64)
        )
        w_loc = jax.lax.dynamic_slice_in_dim(
            widths_all, self._offset, l_local
        )[:, None]  # [L_local, 1] vs [..., L_local, N]
        mask_loc = (jnp.uint64(1) << w_loc) - jnp.uint64(1)
        # valid (limb, digit) slots of the uniform max_r grid, in the
        # reference's (limb, digit) order (ct_reencoder.cpp:49-67)
        sel_idx = np.array(
            [li * max_r + d for li in range(ctx.L) for d in range(ratios[li])],
            dtype=np.int32,
        )
        er = len(sel_idx)

        def decompose_fn(ct):
            # ct: u64[..., size, L_local, N] local coeff-form limbs.
            # Digits above a limb's own ratio are exact zeros (word < q_i
            # < 2^(r_i*bits)), so a uniform max_r grid is safe and keeps
            # one traced shape across devices with unequal ratios.
            digits = jnp.stack(
                [
                    (ct >> (jnp.uint64(d) * w_loc)) & mask_loc
                    for d in range(max_r)
                ],
                axis=-2,
            )  # [..., size, L_local, max_r, N]
            full = jax.lax.all_gather(
                digits, axis_name, axis=digits.ndim - 3, tiled=True
            )  # [..., size, L, max_r, N]
            flat = full.reshape(*full.shape[:-3], ctx.L * max_r, ctx.n)
            sel = jnp.take(flat, sel_idx, axis=-2)  # [..., size, ER, N]
            return sel.reshape(*sel.shape[:-3], sel.shape[-3] * er, ctx.n)

        self.decompose_fn = decompose_fn

    def take_ct_limbs(self, x):
        """This shard's ciphertext-level limbs out of a QP-basis array."""
        return jax.lax.dynamic_slice_in_dim(x, self._offset, self.L, axis=-2)

    def __getattr__(self, name):
        return getattr(self._ctx, name)


def make_sharded_pipeline(
    ctx: PirContext,
    dims: tuple,
    db_ntt,
    mesh: Mesh,
    reply_limbs: int | None = None,
    use_ct_mult: bool = False,
):
    """Jitted multi-query pipeline: (query_cts, galois_keys) -> replies.

    query_cts: u64[Q, num_cts, 2, L, N] with Q a multiple of the mesh
    "batch" axis.  Returns u64[Q, (2·ER)^(d-1), 2, L', N] where L' is
    `reply_limbs` when set (replies mod-switched after the cross-shard
    reduction — ops/modswitch.py) and the full L otherwise.

    db_ntt: the NTT-form database, either u64[prod(dims), L, N]
    (PirDatabase.db_ntt) or already blocked as u64[D0p, prod(dims[1:]),
    L, N] with D0p a multiple of the "db" axis (the per-process assembly
    of parallel/distributed.db_from_shard_rows).

    If the mesh has a "limb" axis, the RNS limb axis of the query, the
    Galois keys, the DB, and all per-limb tables is sharded across it
    (see module docstring); reply_limbs is unsupported in that layout
    (mod-switch needs cross-limb CRT state).

    use_ct_mult: ciphertext-multiplication recursion
    (database.cpp:202-211) instead of digit decomposition.  The returned
    pipeline then takes the relinearization key as a third argument
    (per-request, like the Galois keys).  db/batch axes only: the BEHZ
    ct×ct multiply crosses RNS limbs (base extension), so the limb axis
    is decomposition-mode-only; the db-axis split is exact because every
    zero-padded row's product relinearizes to an exact zero.
    """
    d0 = dims[0]
    dim_sum = sum(dims)
    shape = dict(mesh.shape)
    n_db = shape.get("db", 1)
    n_limb = shape.get("limb", 1)
    if n_limb > 1:
        if ctx.L % n_limb != 0:
            raise ValueError(
                f"limb mesh axis {n_limb} must divide L={ctx.L} exactly"
            )
        if reply_limbs is not None:
            raise ValueError("reply_limbs is unsupported with limb sharding")
        if use_ct_mult:
            raise ValueError(
                "ciphertext-multiplication mode is unsupported with limb "
                "sharding (BEHZ base extension crosses limbs)"
            )

    def _ax(name):
        return name if name in mesh.axis_names else None
    d0p = -(-d0 // n_db) * n_db
    d0_local = d0p // n_db
    local_dims = (d0_local,) + tuple(dims[1:])
    block = 1
    for d in dims[1:]:
        block *= d

    # numpy operands stay numpy until placement (multi-process meshes build
    # their global arrays from host values); device arrays stay on device.
    def _as_is(x):
        return np.asarray(x) if isinstance(x, np.ndarray) else jnp.asarray(x)

    if db_ntt.ndim == 4:
        if db_ntt.shape[0] % n_db or db_ntt.shape[1] != block:
            raise ValueError("blocked database does not match the mesh")
        db_blocks = db_ntt
    else:
        db_blocks = pad_axis(
            _as_is(db_ntt).reshape(d0, block, ctx.L, ctx.n), 0, n_db
        )

    limb_tabs = _limb_tables(ctx) if n_limb > 1 else {}

    def shard_body(query_local, gk, rk, db_local, tabs):
        # query_local: [Q/S_b, num_cts, 2, L/S_l, N]
        # db_local:    [D0p/S_db, B, L/S_l, N]
        cx = _LimbShardView(ctx, tabs, "limb") if n_limb > 1 else ctx
        db_flat = db_local.reshape(-1, *db_local.shape[2:])
        my_db = jax.lax.axis_index("db") if "db" in mesh.axis_names else 0

        def one_query(query_cts):
            # oblivious expansion: subtree-sharded over the db axis (each
            # shard key-switches ~1/n_db of the tree, one all_gather)
            # instead of replicated per shard — ops/expand.py docstring
            if "db" in mesh.axis_names and n_db > 1:
                sv = expand.expand_query_sharded(
                    cx, gk, query_cts, dim_sum, "db", n_db
                )
            else:
                sv = expand.expand_query(cx, gk, query_cts, dim_sum)
            if use_ct_mult:
                # ct-mult consumes the selection vector in COEFF form;
                # dimension-0 rows shard exactly like decomp mode
                sv0 = pad_axis(sv[:d0], 0, n_db)
                sv0_local = jax.lax.dynamic_slice_in_dim(
                    sv0, my_db * d0_local, d0_local, axis=0
                )
                sv_local = jnp.concatenate([sv0_local, sv[d0:]], axis=0)
                partial = scan.database_scan_ctmult(
                    cx, db_flat, local_dims, sv_local, rk
                )
            else:
                sv_ntt = cx.ntt_q.forward(sv)
                sv0 = pad_axis(sv_ntt[:d0], 0, n_db)
                sv0_local = jax.lax.dynamic_slice_in_dim(
                    sv0, my_db * d0_local, d0_local, axis=0
                )
                sv_local = jnp.concatenate([sv0_local, sv_ntt[d0:]], axis=0)
                partial = scan.database_scan_decomp(
                    cx, db_flat, local_dims, sv_local
                )
            # cross-shard homomorphic add: reduced summands, exact u64 psum
            if "db" in mesh.axis_names:
                partial = jax.lax.psum(partial, axis_name="db")
            reply = modular.barrett_reduce_64(
                partial, cx.limbs_q.q, cx.limbs_q.ratio_hi
            )
            if reply_limbs is not None:
                from pir_tpu.ops import modswitch

                reply = modswitch.mod_switch_to(ctx, reply, reply_limbs)
            return reply

        return jax.vmap(one_query)(query_local)

    limb = _ax("limb")
    db_spec = P(_ax("db"), None, limb, None)
    mapped = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(
            P(_ax("batch"), None, None, limb, None),
            P(limb),
            P(),  # relin key: replicated (empty pytree in decomp mode)
            db_spec,
            P(limb),
        ),
        out_specs=P(_ax("batch"), None, None, limb, None),
        check_vma=False,
    )

    # DB operands ride as jit ARGUMENTS, not closure constants: baked
    # constants blow up the HLO, and global (multi-process) jax.Arrays
    # may not be closed over at all.  They are placed with their sharding
    # once, here, so no call re-distributes the database.  Host numpy
    # operands on a multi-process mesh are lifted into sharded global
    # arrays (every process holds the full value and contributes its
    # shards); global arrays stay as they are.
    from jax.sharding import NamedSharding

    multiproc = jax.process_count() > 1

    def _global(arr, spec):
        sh = NamedSharding(mesh, spec)
        if not multiproc:
            return jax.device_put(arr, sh)
        if not isinstance(arr, np.ndarray):
            return arr
        return jax.make_array_from_callback(
            arr.shape, sh, lambda idx, a=arr: a[idx]
        )

    operands = (
        _global(db_blocks, db_spec),
        {k: _global(v, P(limb)) for k, v in limb_tabs.items()},
    )
    jitted = jax.jit(mapped)

    def pipeline(query_cts, gk, relin_key=None):
        return jitted(query_cts, gk, relin_key, *operands)

    return pipeline

#!/usr/bin/env python3
"""The quickest proof that the PIR serving path runs on an NVIDIA GPU.

Runs the SealPIR serving path (PirClient -> PirServer -> PirClient) at the
headline deployment — 1,048,576 items x 288 B, d = 2 (162 x 162), N = 4096,
t = 24 bits, decomposition mode, the reference's benchmark.cpp:17-23 shape —
through the public API, in phases:

  (a) device: every JAX device is a GPU; the database and a reply handle
      live on it (client crypto stays on the CPU by design);
  (b) kernels: forward/inverse NTT, one Galois key switch and the inner
      scan contraction at 162 x 162 x L=2 x 4096, each bit-exact against
      pir_tpu/testing/refmodel on a few polynomials and against the same
      function on the CPU backend on a full batch;
  (c) serving: the 1M database; first/last/random items via
      process_request, 8 requests via process_stream(depth=4), a 4-query
      request via process_request_batched (byte-identical to per-query
      replies), split_pipeline on/off byte-identical; timings;
  (d) --four-cards only: the same deployment served by PirServer(mesh=...)
      over four cards (DB rows on the "db" axis, one psum over NVLink),
      byte-identical to a single-card server in the same process.  With
      this option no other phase runs.

The last stdout line is {"ok": true, "device": {...}} when every phase
passed; any failure exits non-zero without it.  Without a GPU the script
exits non-zero before any phase.

Run: python chip_smoke.py [--four-cards] [--seed S]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def headline_params():
    """1,048,576 x 288 B, d=2, N=4096, t=24 bits (benchmark.cpp:17-23)."""
    from pir_tpu.core.params import (
        create_pir_parameters,
        generate_encryption_params,
    )

    return create_pir_parameters(
        1 << 20, 288, 2, generate_encryption_params(4096, 24)
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only phase (d): the 4-card mesh against one card",
    )
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def phases_for(args) -> list[str]:
    return ["d"] if args.four_cards else ["a", "b", "c"]


def log(msg: str) -> None:
    print(msg, flush=True)


class Stack:
    """Database, client and server of one deployment."""

    def __init__(self, params, seed: int):
        import jax
        import numpy as np

        from pir_tpu.pir.client import PirClient
        from pir_tpu.pir.database import PirDatabase
        from pir_tpu.pir.server import PirServer

        self.params = params
        rng = np.random.default_rng(seed)
        items = rng.integers(
            0, 256, (params.num_items, params.bytes_per_item), dtype=np.uint8
        )
        self.raw = [row.tobytes() for row in items]
        t0 = time.perf_counter()
        self.db = PirDatabase.create(self.raw, params)
        jax.block_until_ready(self.db.db_ntt)
        self.setup_s = time.perf_counter() - t0
        self.reply_limbs = params.reply_limbs()
        self.client = PirClient(params, seed=seed + 1, compress_queries=True)
        self.server = PirServer(self.db, params, reply_limbs=self.reply_limbs)
        self.rng = rng

    def indices(self, count: int) -> list[int]:
        """First, last, then seeded random indices."""
        last = self.params.num_items - 1
        extra = [int(i) for i in self.rng.integers(0, last, max(0, count - 2))]
        return ([0, last] + extra)[:count]

    def check(self, indices, response) -> None:
        got = self.client.process_response(indices, response)
        for idx, item in zip(indices, got):
            if item != self.raw[idx]:
                raise AssertionError(f"item {idx} decoded wrong")


def _same_replies(a, b) -> bool:
    return a.SerializeToString() == b.SerializeToString()


# ---------------------------------------------------------------------------
# (a) device
# ---------------------------------------------------------------------------


def phase_a(stack: Stack, platform: str = "gpu") -> None:
    from pir_tpu import native

    log(f"[a] native encoder: {'loaded' if native.available() else 'not loaded (numpy fallback)'}")
    import jax

    db_devs = {d.platform for d in stack.db.db_ntt.devices()}
    request = stack.client.create_request([0])
    t0 = time.perf_counter()  # the server's first request: compiles
    handles, _ = stack.server.process_request_async(request)

    reply_devs = {
        d.platform
        for leaf in jax.tree_util.tree_leaves(handles)
        for d in leaf.devices()
    }
    log(f"[a] db_ntt on {sorted(db_devs)}, reply handle on {sorted(reply_devs)}")
    if db_devs != {platform} or reply_devs != {platform}:
        raise AssertionError("server arrays are not on the accelerator")
    stack.check([0], stack.server.finalize_response((handles, None)))
    stack.cold_s = time.perf_counter() - t0


# ---------------------------------------------------------------------------
# (b) kernels against the plain reference, at real widths
# ---------------------------------------------------------------------------


def _residues(rng, shape, moduli):
    import numpy as np

    out = np.empty(shape, np.uint64)
    for li, q in enumerate(moduli):
        out[..., li, :] = rng.integers(0, q, shape[:-2] + shape[-1:], dtype=np.uint64)
    return out


def _on(fn, device, *args):
    """fn(*args) with every array placed on `device`, fetched to host."""
    import jax
    import numpy as np

    with jax.default_device(device):
        placed = jax.tree_util.tree_map(lambda a: jax.device_put(a, device), args)
        # a fresh function object per call: each device gets its own trace
        out = jax.jit(lambda *a: fn(*a))(*placed)
        return jax.tree_util.tree_map(np.asarray, out)


def _bit_reverse(j: int, bits: int) -> int:
    return int(format(j, f"0{bits}b")[::-1], 2)


def phase_b(stack: Stack, batch: int = 64) -> None:
    import jax
    import numpy as np

    from pir_tpu.bfv import encrypt as enc_mod
    from pir_tpu.core import primes
    from pir_tpu.ops import keyswitch, scan
    from pir_tpu.testing import refmodel

    ctx = stack.db.ctx
    gpu = stack.db.db_ntt.devices().pop()
    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(7)
    moduli = ctx.ct_moduli
    n, L = ctx.n, ctx.L
    logn = n.bit_length() - 1

    # NTT: full batch vs the CPU backend, spot checks vs the definition
    x = _residues(rng, (batch, L, n), moduli)
    fwd = _on(ctx.ntt_q.forward, gpu, x)
    inv = _on(ctx.ntt_q.inverse, gpu, fwd)
    if not np.array_equal(fwd, _on(ctx.ntt_q.forward, cpu, x)):
        raise AssertionError("forward NTT differs from the CPU backend")
    if not np.array_equal(inv, _on(ctx.ntt_q.inverse, cpu, fwd)):
        raise AssertionError("inverse NTT differs from the CPU backend")
    if not np.array_equal(inv, x):
        raise AssertionError("inverse(forward(x)) != x")
    js = rng.integers(0, n, 16)
    for b in range(2):
        for li, q in enumerate(moduli):
            psi = primes.primitive_root_2n(q, 2 * n)
            ref = refmodel.ntt_points(
                x[b, li], psi, q, [_bit_reverse(int(j), logn) for j in js]
            )
            if [int(v) for v in fwd[b, li, js]] != ref:
                raise AssertionError("forward NTT differs from refmodel")
    a = np.zeros((L, n), np.uint64)
    a[:, rng.integers(0, n, 8)] = 1 + rng.integers(0, 1000, (L, 8)).astype(np.uint64)
    bpoly = _residues(rng, (L, n), moduli)
    prod = _on(ctx.ntt_q.negacyclic_polymul, gpu, a, bpoly)
    for li, q in enumerate(moduli):
        if [int(v) for v in prod[li]] != refmodel.negacyclic_mul(a[li], bpoly[li], q):
            raise AssertionError("NTT polynomial product differs from refmodel")
    log(f"[b] NTT fwd/inv [{batch}, {L}, {n}]: bit-exact vs CPU backend and refmodel")

    # one Galois key switch (the first expansion level's element)
    elt = n + 1
    key = np.asarray(stack.client.galois_keys[elt].data)
    cts = _residues(rng, (batch, 2, L, n), moduli)

    def galois(c, k):
        return keyswitch.apply_galois(ctx, {elt: k}, c, elt)

    got = _on(galois, gpu, cts, key)
    if not np.array_equal(got, _on(galois, cpu, cts, key)):
        raise AssertionError("Galois key switch differs from the CPU backend")
    pt = rng.integers(0, ctx.t, n).astype(np.uint64)
    with ctx.on_host():
        ct = np.asarray(enc_mod.encrypt(ctx, stack.client.pk, pt, rng))
    switched = _on(galois, gpu, ct, key)
    with ctx.on_host():
        dec = enc_mod.decrypt(ctx, stack.client.sk, switched)
    if [int(v) for v in dec] != refmodel.automorphism(pt, elt, ctx.t):
        raise AssertionError("decrypted key switch differs from refmodel")
    log(f"[b] apply_galois [{batch}, 2, {L}, {n}]: bit-exact vs CPU backend; "
        "decrypts to refmodel.automorphism")

    # the inner scan contraction at the deployment's shape
    dims = stack.params.dimensions
    inner, prefix = dims[-1], stack.db.padded_size // dims[-1]
    sv = _residues(rng, (inner, 2, L, n), moduli)
    items = _residues(rng, (prefix, inner, L, n), moduli)

    def contract(s, w):
        return scan.contract_dim(ctx, s, w)

    with jax.default_device(gpu):
        gpu_kernel = scan._gpu_kernel_applies(ctx, inner, n)
    got = _on(contract, gpu, sv, items)
    if not np.array_equal(got, _on(contract, cpu, sv, items)):
        raise AssertionError("scan contraction differs from the CPU backend")
    for _ in range(8):
        p, c, li, col = (int(rng.integers(0, m)) for m in (prefix, 2, L, n))
        ref = refmodel.dot_mod(sv[:, c, li, col], items[p, :, li, col], moduli[li])
        if int(got[p, c, li, col]) != ref:
            raise AssertionError("scan contraction differs from refmodel")
    log(f"[b] scan contraction [{prefix}, {inner}, {L}, {n}] "
        f"({'Triton kernel' if gpu_kernel else 'XLA'}): bit-exact vs CPU "
        "backend and refmodel")


# ---------------------------------------------------------------------------
# (c) serving
# ---------------------------------------------------------------------------


def phase_c(stack: Stack, card: str) -> None:
    from pir_tpu.pir.server import PirServer

    server, client = stack.server, stack.client
    idx = stack.indices(3)
    requests = [client.create_request([i]) for i in idx]
    singles = [server.process_request(r) for r in requests]
    first = singles[0]
    for i, resp in zip(idx, singles):
        stack.check([i], resp)
    log(f"[c] process_request: items {idx} decoded byte-exact")

    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        server.process_request(requests[2])
    seq_s = (time.perf_counter() - t0) / iters

    stream_idx = stack.indices(10)[2:]
    stream_reqs = [client.create_request([i]) for i in stream_idx]
    list(server.process_stream(iter(stream_reqs[:1]), depth=4))  # warm
    t0 = time.perf_counter()
    streamed = list(server.process_stream(iter(stream_reqs), depth=4))
    stream_s = time.perf_counter() - t0
    for i, resp in zip(stream_idx, streamed):
        stack.check([i], resp)
    log(f"[c] process_stream(depth=4): {len(streamed)} requests decoded byte-exact")

    b_idx = stack.indices(6)[2:]
    b_req = client.create_request(b_idx)
    batched = server.process_request_batched(b_req)
    per_query = server.process_request(b_req)
    if not _same_replies(batched, per_query):
        raise AssertionError("batched replies differ from per-query replies")
    stack.check(b_idx, batched)
    log(f"[c] process_request_batched: {len(b_idx)} queries byte-identical to "
        "per-query replies, decoded byte-exact")

    split = server.split_pipeline
    other = PirServer(
        stack.db, stack.params, reply_limbs=stack.reply_limbs,
        split_pipeline=not split,
    )
    t0 = time.perf_counter()
    other_first = other.process_request(requests[0])
    other_cold_s = time.perf_counter() - t0
    if not _same_replies(first, other_first) or not _same_replies(
        singles[1], other.process_request(requests[1])
    ):
        raise AssertionError("split and monolithic pipelines differ")
    log("[c] split_pipeline=True and False: byte-identical replies")

    cold = {split: stack.cold_s, not split: other_cold_s}
    log(f"[c] timings on {card}:")
    log(f"[c]   database setup (encode + NTT, {stack.params.num_pt} plaintexts): "
        f"{stack.setup_s:.3f} s")
    log(f"[c]   cold first request (compile included): split {cold[True]:.3f} s, "
        f"monolithic {cold[False]:.3f} s")
    log(f"[c]   warm sequential: {seq_s * 1e3:.3f} ms/query = {1 / seq_s:.3f} q/s")
    log(f"[c]   streamed depth 4: {len(streamed) / stream_s:.3f} q/s")


# ---------------------------------------------------------------------------
# (d) four cards
# ---------------------------------------------------------------------------


def phase_d(stack: Stack, devices, card: str) -> None:
    from pir_tpu.parallel import sharded
    from pir_tpu.pir.server import PirServer

    mesh = sharded.default_mesh(devices)
    log(f"[d] mesh {dict(mesh.shape)} over {len(devices)} devices")
    mesh_server = PirServer(
        stack.db, stack.params, reply_limbs=stack.reply_limbs, mesh=mesh
    )
    idx = stack.indices(3)
    requests = [stack.client.create_request([i]) for i in idx]
    t0 = time.perf_counter()
    first = mesh_server.process_request(requests[0])
    cold_s = time.perf_counter() - t0
    for i, req in zip(idx, requests):
        mesh_resp = first if i == idx[0] else mesh_server.process_request(req)
        if not _same_replies(mesh_resp, stack.server.process_request(req)):
            raise AssertionError(f"mesh reply for item {i} differs from one card")
        stack.check([i], mesh_resp)
    log(f"[d] items {idx}: mesh replies byte-identical to one card, decoded "
        "byte-exact")
    b_req = stack.client.create_request(idx)
    if not _same_replies(
        mesh_server.process_request_batched(b_req),
        stack.server.process_request(b_req),
    ):
        raise AssertionError("mesh batched replies differ from one card")
    log(f"[d] {len(idx)}-query request: mesh batched replies byte-identical")

    iters = 10
    rates = {}
    for name, srv in (("mesh", mesh_server), ("one card", stack.server)):
        t0 = time.perf_counter()
        for _ in range(iters):
            srv.process_request(requests[2])
        rates[name] = iters / (time.perf_counter() - t0)
    log(f"[d] timings on {card}:")
    log(f"[d]   mesh cold first request: {cold_s:.3f} s")
    log(f"[d]   warm sequential: mesh {rates['mesh']:.3f} q/s, one card "
        f"{rates['one card']:.3f} q/s")


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        from pir_tpu.utils import runtime
    except ImportError as exc:
        print(f"chip_smoke: cannot import the repository: {exc}", file=sys.stderr)
        return 1
    try:
        devices = runtime.require_gpu()
    except runtime.NoGpuError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 1
    phases = phases_for(args)
    if phases == ["d"]:
        if len(devices) < 4:
            print(f"chip_smoke: --four-cards needs 4 GPUs, found {len(devices)}",
                  file=sys.stderr)
            return 1
        devices = devices[:4]
    cache = runtime.enable_compile_cache()
    card = runtime.gpu_name_and_power().replace("\n", " | ")
    log(f"card: {card}")
    log(f"devices: {runtime.device_summary(devices)}; compile cache: {cache}")

    import pir_tpu  # noqa: F401  (64-bit mode)

    t0 = time.perf_counter()
    stack = Stack(headline_params(), args.seed)
    log(f"built {stack.params.num_items} x {stack.params.bytes_per_item} B, "
        f"dims {stack.params.dimensions}, reply_limbs {stack.reply_limbs} "
        f"in {time.perf_counter() - t0:.1f} s")
    failed = []
    runners = {
        "a": lambda: phase_a(stack),
        "b": lambda: phase_b(stack),
        "c": lambda: phase_c(stack, card),
        "d": lambda: phase_d(stack, devices, card),
    }
    for name in phases:
        t0 = time.perf_counter()
        try:
            runners[name]()
        except Exception as exc:  # report every phase, then fail
            import traceback

            traceback.print_exc()
            failed.append(name)
            log(f"[{name}] FAILED: {exc!r}")
        else:
            log(f"[{name}] passed in {time.perf_counter() - t0:.1f} s")
    if failed:
        log(f"phases failed: {failed}")
        return 1
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": runtime.device_summary(devices)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

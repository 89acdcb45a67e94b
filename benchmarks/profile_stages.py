"""Stage-level timing of the served pipeline on the GPU.

Times the end-to-end served query, then each device stage on its own
(expansion, selection-vector NTT, full scan, inner contraction, INTT of
its result, digit decomposition, digit NTT) plus the query upload and
reply readback, each ending in block_until_ready.  Runs on the GPU or
exits non-zero; the first line names the device and card.

Run: python benchmarks/profile_stages.py [--db-size 1048576]
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def bench(name, fn, *args, iters=20):
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        r = fn(*args)
    jax.block_until_ready(r)
    dt = (time.perf_counter() - t0) / iters
    print(f"{name:30s} {dt * 1000:8.3f} ms", flush=True)
    return r


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--db-size", type=int, default=1 << 20)
    ap.add_argument("--profile", default="seal")
    args = ap.parse_args()

    from pir_tpu.utils import runtime

    try:
        devices = runtime.require_gpu()
    except runtime.NoGpuError as exc:
        sys.exit(f"profile_stages.py: {exc}")
    runtime.enable_compile_cache()
    print(json.dumps({
        "device": runtime.device_summary(devices),
        "card": runtime.gpu_name_and_power().replace("\n", " | "),
    }), flush=True)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from pir_tpu.core.params import create_pir_parameters, generate_encryption_params
    from pir_tpu.ops import decompose, expand, scan
    from pir_tpu.pir import wire
    from pir_tpu.pir.client import PirClient
    from pir_tpu.pir.database import PirDatabase
    from pir_tpu.pir.server import PirServer

    db_size = args.db_size
    params = create_pir_parameters(
        db_size, 288, 2,
        generate_encryption_params(4096, 24, profile=args.profile),
    )
    dims = params.dimensions
    dim_sum = params.dimensions_sum
    print("dims:", dims, "num_pt:", params.num_pt, flush=True)
    rng = np.random.default_rng(42)
    raw = [row.tobytes() for row in rng.integers(0, 256, (db_size, 288), dtype=np.uint8)]
    t0 = time.perf_counter()
    db = PirDatabase.create(raw, params)
    jax.block_until_ready(db.db_ntt)
    print(f"db setup {time.perf_counter() - t0:.3f} s", flush=True)
    ctx = db.ctx
    client = PirClient(params, seed=7, compress_queries=True)
    server = PirServer(db, params, reply_limbs=params.reply_limbs())
    req = client.create_request([db_size // 3])

    t0 = time.perf_counter()
    resp = server.process_request(req)
    print(f"first request (compile) {time.perf_counter() - t0:.3f} s", flush=True)
    assert client.process_response([db_size // 3], resp)[0] == raw[db_size // 3]
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        server.process_request(req)
    dt = time.perf_counter() - t0
    print(f"e2e qps={iters / dt:.3f}  per-query {dt / iters * 1000:.3f} ms", flush=True)

    gk_arrays, _ = server._device_keys(req)
    cts = wire.load_ciphertexts(req.query[0], ctx)
    q_dev = jnp.asarray(cts)
    f_expand = jax.jit(lambda q, gk: expand.expand_query(ctx, gk, q, dim_sum))
    sv = bench("expand_query", f_expand, q_dev, gk_arrays)
    f_ntt = jax.jit(ctx.ntt_q.forward)
    sv_ntt = bench("ntt_forward(sv)", f_ntt, sv)
    f_scan = jax.jit(lambda s, d: scan.database_scan_decomp(ctx, d, dims, s))
    reply = bench("full scan", f_scan, sv_ntt, db.db_ntt)

    inner = dims[-1]
    prefix = db.padded_size // inner
    sv_last = sv_ntt[-inner:]
    items = db.db_ntt.reshape(prefix, inner, ctx.L, ctx.n)
    f_inner = jax.jit(lambda s, w: scan.contract_dim(ctx, s, w))
    acc = bench("inner contraction", f_inner, sv_last, items)
    f_intt = jax.jit(ctx.ntt_q.inverse)
    res = bench("intt(inner result)", f_intt, acc)
    f_dec = jax.jit(lambda r: decompose.decompose_ct(ctx, r[:, None]))
    pts = bench("decompose", f_dec, res)
    f_dntt = jax.jit(
        lambda p: ctx.ntt_q.forward(
            jnp.broadcast_to(p[..., None, :], p.shape[:-1] + (ctx.L, ctx.n))
        )
    )
    bench("ntt(digits)", f_dntt, pts)

    t0 = time.perf_counter()
    for _ in range(50):
        jax.device_get(reply)
    print(f"{'reply device_get':30s} {(time.perf_counter() - t0) / 50 * 1000:8.3f} ms")
    t0 = time.perf_counter()
    for _ in range(50):
        jax.block_until_ready(jnp.asarray(cts))
    print(f"{'query host->device':30s} {(time.perf_counter() - t0) / 50 * 1000:8.3f} ms")
    print("reply shape/bytes:", reply.shape, reply.nbytes, " query bytes:", cts.nbytes)


if __name__ == "__main__":
    main()

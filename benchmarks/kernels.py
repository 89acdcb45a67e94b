"""Per-kernel timings on the GPU at the 1M-item deployment's shapes.

Shapes are those of 1,048,576 x 288 B, d=2 (162 x 162), N=4096, t=24 bits:

* ``scan``: the inner scan contraction, 162 prefixes x 162 inner x L=2 x
  N=4096 — the Pallas/Triton kernel (ops/scan_triton.py, the GPU path) at
  a few block shapes against the plain XLA form of the same arithmetic
  (scan.contract_dim off the GPU), each checked bit-exact against it, plus
  a copy yardstick (one read + one write of a DB-sized array);
* ``ntt``: the butterfly NTT at the shapes the serving path feeds it, and
  one batched Galois key switch (expansion level 8: 256 ciphertexts);
* ``e2e``: served sequential queries/s with the kernel and with the plain
  contraction, measured in alternating turns, replies checked identical.

Times are host-clock medians over repeated calls ending in
block_until_ready, in ms.  Every line names the device; without a GPU the
script exits non-zero before measuring anything.

Run: python benchmarks/kernels.py [--only scan|ntt|e2e] [--reps 5] [--out FILE]
"""

import argparse
import contextlib
import json
import pathlib
import statistics
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]


def timeit(fn, *args, reps=5, min_time=0.25):
    """(median ms, min ms, compile+first-run s, output) of fn(*args)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    one = max(time.perf_counter() - t0, 1e-6)
    iters = max(1, int(min_time / one))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            r = fn(*args)
        jax.block_until_ready(r)
        times.append((time.perf_counter() - t0) / iters * 1e3)
    return statistics.median(times), min(times), first, out


def random_residues(key, shape, moduli, limb_axis):
    """Uniform residues mod each limb's modulus, generated on the device."""
    import jax
    import jax.numpy as jnp

    bits = jax.random.bits(key, shape, dtype=jnp.uint64)
    q = np.asarray(moduli, dtype=np.uint64).reshape(
        [-1 if i == limb_axis % len(shape) else 1 for i in range(len(shape))]
    )
    return bits % q


def bench_scan(ctx, emit, reps):
    import jax

    from pir_tpu.ops import scan, scan_triton

    P = D = 162
    L, N = ctx.L, ctx.n
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    sv = random_residues(k1, (D, 2, L, N), ctx.ct_moduli, -2)
    items = random_residues(k2, (P, D, L, N), ctx.ct_moduli, -2)
    db_bytes = items.size * 8
    shape = [P, D, L, N]

    with plain_scan():
        ref_ms, ref_min, ref_first, ref = timeit(
            jax.jit(lambda s, w: scan.contract_dim(ctx, s, w)), sv, items,
            reps=reps,
        )
    emit({"kernel": "scan_inner", "variant": "plain_xla", "shape": shape,
          "ms": ref_ms, "ms_min": ref_min, "first_call_s": ref_first,
          "db_GBps": db_bytes / ref_ms / 1e6, "exact": True})
    for block_n in (256, 512):
        fn = jax.jit(
            lambda s, w, b=block_n: scan_triton.contract_dim(
                s, w, tuple(ctx.ct_moduli), block_n=b
            )
        )
        ms, mn, first, out = timeit(fn, sv, items, reps=reps)
        emit({"kernel": "scan_inner", "variant": f"triton_bn{block_n}",
              "shape": shape, "ms": ms, "ms_min": mn, "first_call_s": first,
              "db_GBps": db_bytes / ms / 1e6,
              "exact": bool(jax.numpy.array_equal(out, ref))})
    ms, mn, _, _ = timeit(jax.jit(lambda w: w + np.uint64(1)), items, reps=reps)
    emit({"kernel": "copy_yardstick", "variant": "x+1", "shape": shape,
          "ms": ms, "ms_min": mn, "GBps_rw": 2 * db_bytes / ms / 1e6})


# ---------------------------------------------------------------------------
# NTT and key switch
# ---------------------------------------------------------------------------


def bench_ntt(ctx, emit, reps):
    import jax

    from pir_tpu.bfv import keys as keys_mod
    from pir_tpu.ops import keyswitch

    N = ctx.n
    shapes = [
        # (name, tables, moduli, batch shape, inverse)
        ("keyswitch_digits_fwd", ctx.ntt_qp, ctx.key_moduli, (256, 2), False),
        ("keyswitch_acc_inv", ctx.ntt_qp, ctx.key_moduli, (256, 2), True),
        ("selection_vector_fwd", ctx.ntt_q, ctx.ct_moduli, (324, 2), False),
        ("inner_result_inv", ctx.ntt_q, ctx.ct_moduli, (162, 2), True),
        ("digit_plaintexts_fwd", ctx.ntt_q, ctx.ct_moduli, (162, 8), False),
    ]
    key = jax.random.PRNGKey(1)
    for name, tables, moduli, batch, inverse in shapes:
        x = random_residues(key, batch + (len(moduli), N), moduli, -2)
        fn = jax.jit(tables.inverse if inverse else tables.forward)
        ms, mn, first, _ = timeit(fn, x, reps=reps)
        emit({"kernel": "ntt", "variant": "butterfly", "case": name,
              "shape": list(x.shape), "ms": ms, "ms_min": mn,
              "first_call_s": first})

    rng = np.random.default_rng(1)
    with ctx.on_host():
        sk = keys_mod.gen_secret_key(ctx, rng)
        gk = keys_mod.gen_galois_keys(ctx, sk, [N + 1], rng)
    key_arr = {N + 1: jax.device_put(np.asarray(gk[N + 1].data))}
    cts = random_residues(key, (256, 2, ctx.L, N), ctx.ct_moduli, -2)
    ms, mn, first, _ = timeit(
        jax.jit(lambda c, k: keyswitch.apply_galois(ctx, k, c, N + 1)),
        cts, key_arr, reps=reps,
    )
    emit({"kernel": "apply_galois", "variant": "butterfly",
          "shape": list(cts.shape), "ms": ms, "ms_min": mn,
          "first_call_s": first})


@contextlib.contextmanager
def plain_scan():
    """Trace scan contractions in the plain XLA form in this scope."""
    from pir_tpu.ops import scan

    saved = scan._gpu_kernel_applies
    scan._gpu_kernel_applies = lambda *a: False
    try:
        yield
    finally:
        scan._gpu_kernel_applies = saved


def bench_e2e(emit, reps, params):
    """Served sequential q/s at the deployment with the Triton scan kernel
    and with the plain XLA contraction, measured in turns."""
    import jax

    from pir_tpu.pir.client import PirClient
    from pir_tpu.pir.database import PirDatabase
    from pir_tpu.pir.server import PirServer

    rng = np.random.default_rng(0)
    raw = [
        row.tobytes()
        for row in rng.integers(
            0, 256, (params.num_items, params.bytes_per_item), dtype=np.uint8
        )
    ]
    db = PirDatabase.create(raw, params)
    jax.block_until_ready(db.db_ntt)
    client = PirClient(params, seed=1, compress_queries=True)
    idx = params.num_items // 3
    request = client.create_request([idx])
    servers = {}
    for name, scope in (("triton", contextlib.nullcontext), ("xla", plain_scan)):
        srv = PirServer(db, params, reply_limbs=params.reply_limbs())
        with scope():  # traces (and compiles) this server's executables
            t0 = time.perf_counter()
            resp = srv.process_request(request)
            first = time.perf_counter() - t0
        assert client.process_response([idx], resp)[0] == raw[idx]
        servers[name] = (srv, first, resp.SerializeToString())
    assert servers["triton"][2] == servers["xla"][2], "replies differ"
    rates = {name: [] for name in servers}
    for turn in range(reps):
        order = ("triton", "xla") if turn % 2 == 0 else ("xla", "triton")
        for name in order:
            srv = servers[name][0]
            t0 = time.perf_counter()
            for _ in range(10):
                srv.process_request(request)
            rates[name].append(10 / (time.perf_counter() - t0))
    for name, (srv, first, _) in servers.items():
        emit({"kernel": "e2e_process_request", "variant": name,
              "db_items": params.num_items, "first_request_s": first,
              "qps": statistics.median(rates[name]), "qps_runs": rates[name],
              "exact": True})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None, help="also append the lines here")
    ap.add_argument("--only", choices=("scan", "ntt", "e2e"), default=None)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(REPO))
    from pir_tpu.utils import runtime

    try:
        devices = runtime.require_gpu()
    except runtime.NoGpuError as exc:
        print(f"kernels.py: {exc}", file=sys.stderr)
        return 2
    runtime.enable_compile_cache()
    card = runtime.gpu_name_and_power()
    dev = runtime.device_summary(devices)
    print(f"card: {card}", flush=True)

    import pir_tpu  # noqa: F401  (x64 mode)
    from pir_tpu.core.context import PirContext
    from pir_tpu.core.params import create_pir_parameters, generate_encryption_params

    params = create_pir_parameters(
        1 << 20, 288, 2, generate_encryption_params(4096, 24)
    )
    ctx = PirContext(params)
    with contextlib.ExitStack() as stack:
        sink = None
        if args.out:
            out_path = pathlib.Path(args.out)
            out_path.parent.mkdir(parents=True, exist_ok=True)
            sink = stack.enter_context(out_path.open("a"))

        def emit(row):
            line = json.dumps({**row, "device": dev, "card": card})
            print(line, flush=True)
            if sink is not None:
                sink.write(line + "\n")

        if args.only in (None, "scan"):
            bench_scan(ctx, emit, args.reps)
        if args.only in (None, "ntt"):
            bench_ntt(ctx, emit, args.reps)
        if args.only in (None, "e2e"):
            bench_e2e(emit, args.reps, params)
    return 0


if __name__ == "__main__":
    sys.exit(main())

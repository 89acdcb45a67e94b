"""Serving throughput at the reference benchmark's shape, on one GPU.

Fixed config (parity with pir/cpp/benchmark.cpp:17-23): 288-byte items,
d=2 recursion, N=4096, 24-bit plain modulus, 1 query per request,
ciphertext-decomposition mode, replies mod-switched to the fewest limbs
the noise budget allows (PirParams.reply_limbs).  Metric: server
ProcessRequest throughput (queries/sec), sequential and through
process_stream.

Each database size is measured in its own child process, one after the
other (one JAX process per card).  Every result line names the device
(platform, device_kind, count) and the card's name and power limit; the
headline (largest completed database) line is printed again last.  A
child that finds no GPU fails, and with no completed stage the script
exits non-zero without printing a result.  The whole run observes a
wall-clock budget (PIR_BENCH_BUDGET seconds, default 900).

  {"metric": "...", "value": N, "unit": "queries/sec", "device": {...}, "card": "..."}
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent

ITEM_SIZE = 288
DIMENSIONS = 2
POLY_DEGREE = 4096
PLAIN_BITS = 24
# parameter profile: "seal" (BFVDefault chain, comparable to the reference
# bit-for-bit) or "tpu32" (the sub-32-bit chain, primes.tpu_coeff_modulus)
PROFILE = os.environ.get("PIR_BENCH_PROFILE", "seal")

_T0 = time.perf_counter()
BUDGET = float(os.environ.get("PIR_BENCH_BUDGET", 900))
_DEADLINE = _T0 + BUDGET
_MARGIN = 10.0

# The 1M-item headline runs first; min_need only gates later stages.
STAGES = (
    {"db_size": 1 << 20, "min_need": 120.0},
    {"db_size": 1 << 16, "min_need": 60.0},
)


def _remaining() -> float:
    return _DEADLINE - time.perf_counter()


def _log(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - _T0:.1f}s] {msg}", file=sys.stderr)
    sys.stderr.flush()


def build_stack(db_size):
    import numpy as np

    from pir_tpu.core.params import (
        create_pir_parameters,
        generate_encryption_params,
    )
    from pir_tpu.pir.client import PirClient
    from pir_tpu.pir.database import PirDatabase
    from pir_tpu.pir.server import PirServer

    params = create_pir_parameters(
        db_size, ITEM_SIZE, DIMENSIONS,
        generate_encryption_params(POLY_DEGREE, PLAIN_BITS, profile=PROFILE),
    )
    rng = np.random.default_rng(42)
    raw = [
        row.tobytes()
        for row in rng.integers(0, 256, (db_size, ITEM_SIZE), dtype=np.uint8)
    ]
    db = PirDatabase.create(raw, params)
    client = PirClient(params, seed=7, compress_queries=True)
    server = PirServer(db, params, reply_limbs=params.reply_limbs())
    return params, raw, db, client, server


def measure_qps(db_size: int, max_iters: int, time_cap: float):
    """Build + warm + measure; each measurement loop stops at max_iters or
    when time_cap (seconds) is exhausted, whichever first."""
    params, raw, db, client, server = build_stack(db_size)
    _log(f"stack built, dims={params.dimensions}, num_pt={params.num_pt}")
    idx = db_size // 3
    request = client.create_request([idx])
    resp = server.process_request(request)  # the one warmup/compile run
    out = client.process_response([idx], resp)
    if out[0] != raw[idx]:
        raise AssertionError("benchmark retrieval mismatch")

    t_end = time.perf_counter() + time_cap
    t0 = time.perf_counter()
    iters = 0
    while iters < max_iters:
        server.process_request(request)  # reply is host bytes: timing closed
        iters += 1
        if time.perf_counter() >= t_end:
            break
    seq = iters / (time.perf_counter() - t0)

    # process_stream: the caller thread submits device work while a worker
    # thread completes reply readback and serialization
    depth = 4
    t0 = time.perf_counter()
    t_end = t0 + time_cap

    def request_stream():
        for _ in range(3 * max_iters):
            if time.perf_counter() >= t_end:
                return
            yield request

    iters = sum(1 for _ in server.process_stream(request_stream(), depth=depth))
    return seq, iters / (time.perf_counter() - t0)


def _child(db_size: int, iters: int, cap: float) -> int:
    sys.path.insert(0, str(REPO))
    from pir_tpu.utils import runtime

    try:
        devices = runtime.require_gpu()
    except runtime.NoGpuError as exc:
        print(f"bench: {exc}", file=sys.stderr)
        return 2
    runtime.enable_compile_cache()
    import pir_tpu  # noqa: F401  (64-bit mode)

    seq, streamed = measure_qps(db_size, iters, cap)
    print(json.dumps({
        "qps": seq, "qps_streamed": streamed,
        "device": runtime.device_summary(devices),
        "card": runtime.gpu_name_and_power().replace("\n", " | "),
    }), flush=True)
    return 0


def _measure_child(db_size: int, iters: int, timeout: float) -> dict:
    env = dict(os.environ)
    cap = max(10.0, min(60.0, timeout / 4))
    out = subprocess.run(
        [sys.executable, str(REPO / "bench.py"), "--child", str(db_size),
         "--iters", str(iters), "--cap", str(cap)],
        env=env, capture_output=True, text=True, timeout=timeout,
    )
    sys.stderr.write(out.stderr[-2000:])
    if out.returncode != 0:
        raise RuntimeError(f"child exited {out.returncode}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--cap", type=float, default=30.0, help=argparse.SUPPRESS)
    ap.add_argument("--iters", type=int, default=150)
    args = ap.parse_args()
    if args.child is not None:
        return _child(args.child, args.iters, args.cap)

    emitted = []
    for stage in STAGES:
        db_size = stage["db_size"]
        room = _remaining() - _MARGIN
        if emitted and room < stage["min_need"]:
            _log(f"skipping db_size={db_size}: {room:.0f}s left")
            continue
        try:
            res = _measure_child(db_size, args.iters, max(30.0, room))
        except (RuntimeError, subprocess.TimeoutExpired, ValueError) as exc:
            _log(f"stage db_size={db_size} failed: {exc!r}")
            continue
        prof = "" if PROFILE == "seal" else f", {PROFILE} profile"
        for key, note in (("qps", ""), ("qps_streamed", ", streamed depth 4")):
            line = json.dumps({
                "metric": f"server ProcessRequest throughput, {db_size}-item "
                f"DB, 288B items, d=2, N=4096 (decomp mode{prof}){note}",
                "value": res[key],
                "unit": "queries/sec",
                "device": res["device"],
                "card": res["card"],
            })
            emitted.append((db_size, line))
            print(line, flush=True)
    if not emitted:
        _log("no stage completed")
        return 1
    best = max(db for db, _ in emitted)
    print([line for db, line in emitted if db == best][-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Batched-query throughput — BASELINE config 4 ("batched queries amortizing
the DB scan").  Measures process_request_batched at several batch widths.

Runs on the GPU or exits non-zero; every line names the device.

Run: python benchmarks/batched.py [--db-size N] [--batches 1,8,32]
Prints one JSON line per batch width.
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--db-size", type=int, default=4096)
    ap.add_argument("--batches", default="1,8,32")
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()

    from pir_tpu.utils import runtime

    try:
        devices = runtime.require_gpu()
    except runtime.NoGpuError as exc:
        sys.exit(f"{pathlib.Path(__file__).name}: {exc}")
    runtime.enable_compile_cache()
    device = runtime.device_summary(devices)
    card = runtime.gpu_name_and_power().replace("\n", " | ")
    print(json.dumps({"device": device, "card": card}), flush=True)

    import numpy as np

    from pir_tpu.core.params import (
        create_pir_parameters,
        generate_encryption_params,
    )
    from pir_tpu.pir.client import PirClient
    from pir_tpu.pir.database import PirDatabase
    from pir_tpu.pir.server import PirServer

    size = args.db_size
    params = create_pir_parameters(
        size, 288, 2, generate_encryption_params(4096, 24)
    )
    rng = np.random.default_rng(42)
    base = [rng.integers(0, 256, 288, dtype=np.uint8).tobytes() for _ in range(2048)]
    raw = [base[i % 2048] for i in range(size)]
    db = PirDatabase.create(raw, params)
    client = PirClient(params, seed=7, compress_queries=True)
    server = PirServer(db, params, reply_limbs=params.reply_limbs())

    for b in [int(x) for x in args.batches.split(",")]:
        indices = [int(rng.integers(0, size)) for _ in range(b)]
        request = client.create_request(indices)
        resp = server.process_request_batched(request)  # compile
        out = client.process_response(indices, resp)
        assert all(out[i] == raw[indices[i]] for i in range(b))
        t0 = time.perf_counter()
        for _ in range(args.iters):
            resp = server.process_request_batched(request)
        dt = (time.perf_counter() - t0) / args.iters
        # streamed: a queue of batch-b requests through process_stream
        # (the worker thread overlaps reply readback with later compute)
        n_req = max(2 * args.iters, 6)
        for _ in server.process_stream(iter([request]), depth=1):
            pass  # warm the async path's executables out of the timing
        t0 = time.perf_counter()
        for _ in server.process_stream((request for _ in range(n_req)), depth=3):
            pass
        dts = (time.perf_counter() - t0) / n_req
        print(
            json.dumps(
                {
                    "metric": "batched ProcessRequest",
                    "device": device,
                    "db_size": size,
                    "batch": b,
                    "seconds_per_request": round(dt, 4),
                    "queries_per_sec": round(b / dt, 3),
                    "queries_per_sec_streamed": round(b / dts, 3),
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()

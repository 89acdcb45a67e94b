"""Four-phase benchmark suite — full parity with the reference's
Google-Benchmark harness (pir/cpp/benchmark.cpp:56-107): SetupDb,
ClientCreateRequest, ServerProcessRequest, ClientProcessResponse, swept
over DB sizes 2^8..2^16 (RangeMultiplier 2 in the reference; we default to
a coarser sweep to keep the compile count down).  Runs on the GPU or
exits non-zero; every line names the device.

Run: python benchmarks/phases.py [--sizes 256,4096,65536] [--iters 3]
Prints one JSON line per (phase, size).
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

ITEM_SIZE = 288
DIMENSIONS = 2
POLY_DEGREE = 4096
PLAIN_BITS = 24


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="256,4096,65536")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--queries", type=int, default=1)
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

    import jax
    import numpy as np

    from pir_tpu.core.params import (
        create_pir_parameters,
        generate_encryption_params,
    )
    from pir_tpu.pir.client import PirClient
    from pir_tpu.pir.database import PirDatabase
    from pir_tpu.pir.server import PirServer

    enc = generate_encryption_params(POLY_DEGREE, PLAIN_BITS)

    for size in [int(s) for s in args.sizes.split(",")]:
        params = create_pir_parameters(size, ITEM_SIZE, DIMENSIONS, enc)
        rng = np.random.default_rng(42)
        base_items = [
            rng.integers(0, 256, ITEM_SIZE, dtype=np.uint8).tobytes()
            for _ in range(min(size, 4096))
        ]
        raw = [base_items[i % len(base_items)] for i in range(size)]

        t0 = time.perf_counter()
        db = PirDatabase.create(raw, params)
        jax.block_until_ready(db.db_ntt)
        setup_s = time.perf_counter() - t0
        print(
            json.dumps(
                {"phase": "SetupDb", "db_size": size, "device": device,
                 "seconds": round(setup_s, 3)}
            ),
            flush=True,
        )

        client = PirClient.create(params, seed=7)
        server = PirServer.create(db, params)
        indices = [int(rng.integers(0, size)) for _ in range(args.queries)]

        t0 = time.perf_counter()
        for _ in range(args.iters):
            request = client.create_request(indices)
        dt = (time.perf_counter() - t0) / args.iters
        print(
            json.dumps(
                {"phase": "ClientCreateRequest", "db_size": size,
                 "seconds": round(dt, 4)}
            ),
            flush=True,
        )

        response = server.process_request(request)  # warm up / compile
        t0 = time.perf_counter()
        for _ in range(args.iters):
            response = server.process_request(request)
        dt = (time.perf_counter() - t0) / args.iters
        print(
            json.dumps(
                {"phase": "ServerProcessRequest", "db_size": size,
                 "device": device, "seconds": round(dt, 4),
                 "queries_per_sec": round(args.queries / dt, 3)}
            ),
            flush=True,
        )

        t0 = time.perf_counter()
        for _ in range(args.iters):
            results = client.process_response(indices, response)
        dt = (time.perf_counter() - t0) / args.iters
        assert results[0] == raw[indices[0]]
        print(
            json.dumps(
                {"phase": "ClientProcessResponse", "db_size": size,
                 "seconds": round(dt, 4)}
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()

"""High-throughput serving demo: a request queue through process_stream.

Shows the three serving shapes on one database:

  1. sequential  — process_request per request (the reference's loop,
                   pir/cpp/server.cpp:60-63)
  2. streamed    — process_stream: the caller thread keeps the device fed
                   while a worker thread completes reply downloads
  3. batched+streamed — multi-query requests, each query served in turn

Run: python examples/streamed_serving.py [--db-size 65536] [--requests 12]
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--db-size", type=int, default=65536)
    ap.add_argument("--item-size", type=int, default=288)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from pir_tpu.core.params import (
        create_pir_parameters,
        generate_encryption_params,
    )
    from pir_tpu.pir.client import PirClient
    from pir_tpu.pir.database import PirDatabase
    from pir_tpu.pir.server import PirServer

    size = args.db_size
    params = create_pir_parameters(
        size, args.item_size, 2, generate_encryption_params(4096, 24)
    )
    rng = np.random.default_rng(0)
    pool = [
        rng.integers(0, 256, args.item_size, dtype=np.uint8).tobytes()
        for _ in range(2048)
    ]
    raw = [pool[i % 2048] for i in range(size)]
    print(f"building database ({size} items)...", flush=True)
    db = PirDatabase.create(raw, params)
    client = PirClient(params, seed=11, compress_queries=True)
    server = PirServer(db, params)

    idx = [int(rng.integers(0, size)) for _ in range(args.requests)]
    single = [client.create_request([i]) for i in idx]
    batched = [
        client.create_request(idx[k : k + args.batch])
        for k in range(0, len(idx), args.batch)
    ]
    print("warming up (first-request jit compile)...", flush=True)
    client.process_response([idx[0]], server.process_request(single[0]))

    t0 = time.perf_counter()
    seq = [server.process_request(r) for r in single]
    dt_seq = time.perf_counter() - t0

    t0 = time.perf_counter()
    streamed = list(server.process_stream(iter(single), depth=6))
    dt_stream = time.perf_counter() - t0

    server.process_request(batched[0])  # warm the multi-query shapes
    t0 = time.perf_counter()
    wide = list(server.process_stream(iter(batched), depth=3))
    dt_wide = time.perf_counter() - t0

    # every shape returns byte-identical, correct replies
    for k, i in enumerate(idx):
        a = client.process_response([i], seq[k])[0]
        b = client.process_response([i], streamed[k])[0]
        assert a == b == raw[i]
    flat = [
        client.process_response(idx[k : k + args.batch], resp)
        for k, resp in zip(range(0, len(idx), args.batch), wide)
    ]
    assert [x for grp in flat for x in grp] == [raw[i] for i in idx]

    n = len(idx)
    print(f"sequential        : {n / dt_seq:6.2f} queries/s")
    print(f"streamed depth 6  : {n / dt_stream:6.2f} queries/s")
    print(f"batch-{args.batch} streamed : {n / dt_wide:6.2f} queries/s")


if __name__ == "__main__":
    main()

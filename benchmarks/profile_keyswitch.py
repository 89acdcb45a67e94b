"""Stage breakdown of one batched Galois key switch on the live backend.

Times each phase of ops/keyswitch.switch_key separately (decompose /
digit NTT / inner product / INTT / P-scale-down) plus the surrounding
apply_galois permutation, at the oblivious-expansion batch shape.  Runs
on the GPU or exits non-zero; the first line names the device and card.

Run: python benchmarks/profile_keyswitch.py [--batch B] [--profile seal|tpu32]
"""

import argparse
import json
import pathlib
import sys
import time

import numpy as np


def bench(fn, *args, iters=20):
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--profile", default="seal")
    args = ap.parse_args()

    from pir_tpu.utils import runtime

    try:
        devices = runtime.require_gpu()
    except runtime.NoGpuError as exc:
        sys.exit(f"profile_keyswitch.py: {exc}")
    runtime.enable_compile_cache()
    print(json.dumps({
        "device": runtime.device_summary(devices),
        "card": runtime.gpu_name_and_power().replace("\n", " | "),
    }), flush=True)

    import jax
    import jax.numpy as jnp

    from pir_tpu.core.params import create_pir_parameters, generate_encryption_params
    from pir_tpu.core.context import PirContext
    from pir_tpu.ops import keyswitch, modular, poly
    from pir_tpu.bfv import keys as keys_mod

    N = args.n
    kb = args.batch
    params = create_pir_parameters(
        16, 0, 1, generate_encryption_params(N, 20, profile=args.profile)
    )
    ctx = PirContext(params)
    rng = np.random.default_rng(0)
    sk = keys_mod.gen_secret_key(ctx, rng)
    gk = keys_mod.gen_galois_keys(ctx, sk, [N + 1], rng)
    key = jnp.asarray(gk[N + 1].data)
    qp = ctx.limbs_qp

    c = jnp.asarray(
        np.stack(
            [
                rng.integers(0, int(q), size=(kb, N), dtype=np.uint64)
                for q in ctx.ct_moduli
            ],
            axis=1,
        )
    )  # [kb, L, N]

    f_dec = jax.jit(
        lambda x: modular.barrett_reduce_64(x[..., :, None, :], qp.q, qp.ratio_hi)
    )
    digits = f_dec(c)
    f_ntt = jax.jit(ctx.ntt_qp.forward)
    digits_ntt = f_ntt(digits)
    f_ip = jax.jit(
        lambda d, k: keyswitch._digit_inner_product(ctx, d, k, qp)
    )
    acc = f_ip(digits_ntt, key)
    f_intt = jax.jit(ctx.ntt_qp.inverse)
    acc_c = f_intt(acc)

    def scale_down(a):
        t_last = a[..., ctx.Lp - 1 : ctx.Lp, :]
        p = jnp.uint64(int(ctx.special))
        u = t_last + ctx.p_half_u64
        u = jnp.where(u >= p, u - p, u)
        lq = ctx.limbs_q
        u_mod_q = modular.barrett_reduce_64(u, lq.q, lq.ratio_hi)
        t_bar = modular.sub_mod(u_mod_q, ctx.p_half_mod_q, lq.q)
        return modular.mul_mod_shoup(
            modular.sub_mod(ctx.take_ct_limbs(a), t_bar, lq.q),
            ctx.p_inv_mod_q,
            ctx.p_inv_mod_q_shoup,
            lq.q,
        )

    f_scale = jax.jit(scale_down)
    f_perm = jax.jit(
        lambda x: poly.galois_transform(ctx, x, N + 1)
    )
    f_full = jax.jit(lambda cc, k: keyswitch.switch_key(ctx, k, cc))

    rows = [
        ("galois_permute [kb,L,N]", bench(f_perm, c)),
        ("decompose     [kb,L,Lp,N]", bench(f_dec, c)),
        ("digit NTT     [kb,L,Lp,N]", bench(f_ntt, digits)),
        ("inner product", bench(f_ip, digits_ntt, key)),
        ("INTT          [kb,2,Lp,N]", bench(f_intt, acc)),
        ("P scale-down", bench(f_scale, acc_c)),
        ("switch_key (full)", bench(f_full, c, key)),
    ]
    print(f"profile={args.profile} N={N} batch={kb} L={ctx.L} Lp={ctx.Lp}")
    for name, dt in rows:
        print(f"  {name:28s} {dt * 1e3:8.3f} ms")


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    main()

"""The DB-scan contraction: raw 128-bit column sums against big-int
arithmetic at every modulus width class, the Triton kernel (interpret
mode) against the plain form, and the choice between them."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pir_tpu.core.context import PirContext
from pir_tpu.ops import modular, scan, scan_triton
from pir_tpu.testing import refmodel
from pir_tpu.testing.params import tiny_pir_params

# ct-limb widths: sub-32-bit (one-word products), the test default, the
# SEAL N=4096 widths, the kernel's 48-bit ceiling, and two chains above it
# whose column sums need chunking (61 bits: 2 products per chunk).
WIDTHS = [
    (20, 20, 19, 30),
    (26, 27, 28),
    (36, 36, 37),
    (44, 48, 50),
    (50, 50, 52),
    (60, 60, 61),
]


def _ctx(q_bits, n=256):
    return PirContext(tiny_pir_params(n=n, t_bits=13, q_bits=q_bits))


def _operands(rng, ctx, P, D):
    L, N = ctx.L, ctx.n
    db = np.zeros((P, D, L, N), dtype=np.uint64)
    sv = np.zeros((D, 2, L, N), dtype=np.uint64)
    for li, q in enumerate(ctx.ct_moduli):
        db[:, :, li] = rng.integers(0, q, size=(P, D, N), dtype=np.uint64)
        sv[:, :, li] = rng.integers(0, q, size=(D, 2, N), dtype=np.uint64)
    return sv, db


def _bigint_contract(ctx, sv, db):
    out = np.zeros((db.shape[0], 2, ctx.L, ctx.n), dtype=object)
    for li, q in enumerate(ctx.ct_moduli):
        out[:, :, li] = np.einsum(
            "dcn,pdn->pcn", sv[:, :, li].astype(object),
            db[:, :, li].astype(object),
        ) % q
    return out


@pytest.mark.parametrize("q_bits", WIDTHS)
def test_contract_dim_matches_bigint(rng, q_bits):
    ctx = _ctx(q_bits)
    sv, db = _operands(rng, ctx, P=3, D=7)
    got = np.asarray(scan.contract_dim(ctx, jnp.asarray(sv), jnp.asarray(db)))
    assert (got.astype(object) == _bigint_contract(ctx, sv, db)).all()
    p, c, li, col = 2, 1, ctx.L - 1, 17
    assert int(got[p, c, li, col]) == refmodel.dot_mod(
        sv[:, c, li, col], db[p, :, li, col], ctx.ct_moduli[li]
    )


@pytest.mark.parametrize("bits", [20, 32, 36, 48, 61])
def test_sum_products_128_at_the_top_of_the_range(bits):
    """All-maximal operands: every partial column at its bound."""
    top = (1 << bits) - 1
    terms = 1 << max(0, min(10, 62 - bits))
    x = jnp.full((terms, 3), top, jnp.uint64)
    hi, lo = modular.sum_products_128(x, x, axis=0)
    total = terms * top * top
    assert int(hi[0]) == total >> 64 and int(lo[0]) == total & ((1 << 64) - 1)


@pytest.mark.parametrize("q_bits", [WIDTHS[0], WIDTHS[1], WIDTHS[2], WIDTHS[3]])
@pytest.mark.parametrize("block_n", [64, 128])
def test_triton_kernel_matches_plain(rng, q_bits, block_n):
    ctx = _ctx(q_bits)
    sv, db = _operands(rng, ctx, P=3, D=9)
    plain = np.asarray(scan.contract_dim(ctx, jnp.asarray(sv), jnp.asarray(db)))
    got = np.asarray(
        scan_triton.contract_dim(
            jnp.asarray(sv), jnp.asarray(db), tuple(ctx.ct_moduli),
            block_n=block_n, interpret=True,
        )
    )
    assert (got == plain).all()


def test_triton_kernel_rejects_wide_moduli(rng):
    ctx = _ctx(WIDTHS[4])
    sv, db = _operands(rng, ctx, P=1, D=2)
    assert not scan_triton.supported(ctx.ct_moduli, 2)
    with pytest.raises(ValueError, match="too wide"):
        scan_triton.contract_dim(
            jnp.asarray(sv), jnp.asarray(db), tuple(ctx.ct_moduli),
            block_n=64, interpret=True,
        )


@pytest.mark.parametrize(
    "on_gpu,q_bits,limb_view,expect",
    [
        (False, WIDTHS[2], False, False),  # CPU: the plain form
        (True, WIDTHS[2], False, True),  # GPU, 36/37-bit chain: kernel
        (True, WIDTHS[4], False, False),  # moduli above 48 bits: plain
        (True, WIDTHS[2], True, False),  # limb-sharded view: plain
    ],
)
def test_kernel_choice(monkeypatch, on_gpu, q_bits, limb_view, expect):
    ctx = _ctx(q_bits)
    if limb_view:
        ctx = type("View", (), {"limb_axis_name": "limb",
                                "ct_moduli": ctx.ct_moduli})()
    monkeypatch.setattr(scan, "_on_gpu", lambda: on_gpu)
    assert scan._gpu_kernel_applies(ctx, 162, 256) is expect


def test_cpu_default_device_scope_is_not_gpu():
    with jax.default_device(jax.devices("cpu")[0]):
        assert not scan._on_gpu()


@pytest.mark.parametrize("dims", [(12,), (3, 4)])
def test_scan_through_kernel_matches_plain(rng, monkeypatch, dims):
    """database_scan_decomp with the kernel chosen (interpret mode) equals
    the plain path end to end, upper recursion levels included."""
    ctx = _ctx(WIDTHS[2], n=128)
    total = int(np.prod(dims))
    db = np.zeros((total, ctx.L, ctx.n), dtype=np.uint64)
    sv = np.zeros((sum(dims), 2, ctx.L, ctx.n), dtype=np.uint64)
    for li, q in enumerate(ctx.ct_moduli):
        db[:, li] = rng.integers(0, q, size=(total, ctx.n), dtype=np.uint64)
        sv[:, :, li] = rng.integers(0, q, size=(sum(dims), 2, ctx.n), dtype=np.uint64)
    plain = np.asarray(
        scan.database_scan_decomp(ctx, jnp.asarray(db), dims, jnp.asarray(sv))
    )
    kernel = scan_triton.contract_dim
    calls = []

    def interpreted(*args, **kwargs):
        calls.append(1)
        return kernel(*args, **{**kwargs, "interpret": True})

    monkeypatch.setattr(scan, "_on_gpu", lambda: True)
    monkeypatch.setattr(scan_triton, "contract_dim", interpreted)
    got = np.asarray(
        scan.database_scan_decomp(ctx, jnp.asarray(db), dims, jnp.asarray(sv))
    )
    assert len(calls) == len(dims)
    assert (got == plain).all()

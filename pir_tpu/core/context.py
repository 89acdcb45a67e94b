"""PirContext: precomputed device tables for one parameter set.

The analog of the reference's ``PIRContext``
(pir/cpp/context.{h,cpp}) *plus* everything SEAL's ``SEALContext``
precomputes behind it: NTT twiddle tables per RNS limb, Barrett/Shoup
constants, Galois automorphism permutations, key-switching scale-down
constants, and plaintext-lift (Δ) residues.  Client, server, and database
each build their own context from the shared ``PirParams``, mirroring the
reference's ownership model (context recreated from the serialized params —
SURVEY §1 "ownership quirk").

All tables are host-precomputed numpy constants; jitted functions close
over them, so XLA sees them as literals.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np

from pir_tpu.core.params import EncryptionParams, PirParams
from pir_tpu.ops import modular
from pir_tpu.ops.ntt import NttTables


class PirContext:
    # Set on per-shard views (parallel/sharded.py) when the RNS limb axis is
    # sharded over a mesh axis; the base context is always limb-dense.
    limb_axis_name: "str | None" = None

    @classmethod
    def for_params(cls, params: PirParams) -> "PirContext":
        """Shared context for a parameter set (process-wide memo).

        Contexts are pure precomputation (tables + jit caches), so every
        party holding the same ``PirParams`` can share one — preserving
        the reference's per-party-context *semantics* (each party can
        always rebuild from the serialized params; SURVEY §1) while
        skipping redundant twiddle/keyswitch-constant construction and,
        more importantly, re-jitting identical programs.
        """
        ctx = _CONTEXT_CACHE.get(params)
        if ctx is None:
            ctx = cls(params)
            _CONTEXT_CACHE[params] = ctx
        return ctx

    def take_ct_limbs(self, x):
        """Select the ciphertext-level limbs this context owns from a
        full-key-basis array ``[..., Lp, N]``.  Limb-sharded views override
        this with the device's own slice."""
        return x[..., : self.L, :]

    def __init__(self, params: PirParams):
        self.params = params
        self.enc: EncryptionParams = params.encryption_params
        self.enc.validate()

        n = self.enc.poly_modulus_degree
        self.n = n
        self.t = self.enc.plain_modulus

        # RNS chains: key level (QP) and ciphertext level (q).
        self.key_moduli = self.enc.coeff_modulus
        self.ct_moduli = self.enc.ct_modulus
        self.L = len(self.ct_moduli)
        self.Lp = len(self.key_moduli)

        self.ntt_qp = NttTables(self.key_moduli, n)
        self.ntt_q = self.ntt_qp.slice(self.L)
        self.limbs_qp = self.ntt_qp.limbs
        self.limbs_q = self.ntt_q.limbs

        # Plaintext modulus constants (vector ops mod t).
        t_hi, t_lo = modular.barrett_ratio(self.t)
        self.t_u64 = np.uint64(self.t)
        self.t_ratio_hi = np.uint64(t_hi)
        self.t_ratio_lo = np.uint64(t_lo)

        # Δ = floor(q/t) residues for plaintext lifting (BFV encrypt).
        self.q_big = self.enc.q
        self.delta_big = self.q_big // self.t
        delta = np.array(
            [[self.delta_big % m] for m in self.ct_moduli], dtype=np.uint64
        )
        self.delta_mod_q = delta
        self.delta_mod_q_shoup = modular.shoup_precompute(delta, self.limbs_q.q)

        # Key-switching scale-down constants (only with a special prime).
        self.special = self.enc.special_modulus
        if self.special is not None:
            p = self.special
            p_half = p >> 1
            self.p_half_u64 = np.uint64(p_half)
            self.p_half_mod_q = np.array(
                [[p_half % m] for m in self.ct_moduli], dtype=np.uint64
            )
            p_inv = np.array(
                [[pow(p % m, -1, m)] for m in self.ct_moduli], dtype=np.uint64
            )
            self.p_inv_mod_q = p_inv
            self.p_inv_mod_q_shoup = modular.shoup_precompute(p_inv, self.limbs_q.q)
            self.p_mod_q = np.array(
                [[p % m] for m in self.ct_moduli], dtype=np.uint64
            )

        # CRT reconstruction constants for exact decrypt (host-side) are
        # built lazily per modulus level in _crt_consts (mod-switched
        # ciphertexts decrypt at a reduced level).

        # per-context cache for jitted helper entry points (keygen/encrypt
        # device math would otherwise dispatch op-by-op on the host backend)
        self.jit_cache: dict = {}

    def jitted(self, name: str, builder):
        """Memoize jax.jit(builder()) under `name` for this context."""
        fn = self.jit_cache.get(name)
        if fn is None:
            import jax

            fn = jax.jit(builder())
            self.jit_cache[name] = fn
        return fn

    def maybe_jitted(self, name: str, builder, *args):
        """Run builder() over args — jitted (memoized) for eager callers,
        inline when already inside a trace.

        Library entry points (expansion, key switching, the scan) are
        called both from inside the server's compiled pipelines and
        eagerly from tests / the component-level API; eager op-by-op
        dispatch of a few thousand tiny XLA ops costs tens of seconds on
        the CPU backend, so the eager path routes through one compiled
        executable instead (jax.jit retraces per shape as usual)."""
        import jax

        leaves = jax.tree_util.tree_leaves(args)
        if any(isinstance(a, jax.core.Tracer) for a in leaves):
            return builder()(*args)
        # Non-pytree wrapper objects (e.g. a GaloisKeys dataclass) would
        # hide tracers from the check above AND fail inside jax.jit below
        # with an opaque error — callers must pre-unwrap to arrays/dicts.
        bad = [
            type(a).__name__
            for a in leaves
            if not (hasattr(a, "dtype") or hasattr(a, "__array__")
                    or isinstance(a, (int, float, bool)) or a is None)
        ]
        if bad:
            raise TypeError(
                f"maybe_jitted({name!r}) requires array-like leaves; got "
                f"opaque objects {bad} — unwrap key containers to their "
                f".data arrays before the call"
            )
        return self.jitted(name, builder)(*args)

    # ------------------------------------------------------------------
    # Permutation tables (Galois automorphisms, negacyclic monomial shifts)
    # ------------------------------------------------------------------
    @functools.lru_cache(maxsize=None)
    def galois_permutation(self, galois_elt: int):
        """(src_index[N] int32, flip_sign[N] bool) for x -> x^galois_elt.

        out[dst] = ±in[src]: semantics of seal::util::apply_galois as used
        by PIRServer::substitute_power_x_inplace (pir/cpp/server.cpp:67-76).
        """
        n = self.n
        if galois_elt % 2 == 0:
            raise ValueError("galois element must be odd")
        src = np.zeros(n, dtype=np.int32)
        flip = np.zeros(n, dtype=bool)
        for i in range(n):
            j = (i * galois_elt) % (2 * n)
            if j < n:
                src[j] = i
                flip[j] = False
            else:
                src[j - n] = i
                flip[j - n] = True
        return src, flip

    @functools.lru_cache(maxsize=None)
    def monomial_shift_permutation(self, index: int):
        """(src_index[N], flip_sign[N]) for multiplication by x^index.

        index in [0, 2N); semantics of
        seal::util::negacyclic_shift_poly_coeffmod (pir/cpp/server.cpp:97-100).
        """
        n = self.n
        index = index % (2 * n)
        src = np.zeros(n, dtype=np.int32)
        flip = np.zeros(n, dtype=bool)
        for i in range(n):
            j = (i + index) % (2 * n)
            if j < n:
                src[j] = i
                flip[j] = False
            else:
                src[j - n] = i
                flip[j - n] = True
        return src, flip

    # ------------------------------------------------------------------
    # Device placement
    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def on_host(self):
        """Run client-side crypto on the CPU backend when one is registered.

        Keygen/encrypt/decrypt are the client's work and latency-
        insensitive; keeping them off the accelerator leaves the card to
        the server and matches a deployment, where the client is another
        machine.  No CPU backend registered -> no-op.
        """
        import jax

        try:
            # local_devices, not devices: in multi-process mode global
            # device 0 may belong to another process, and computing onto a
            # non-addressable device yields arrays this process can't read
            cpu = jax.local_devices(backend="cpu")[0]
        except RuntimeError:
            cpu = None
        if cpu is None:
            yield
        else:
            with jax.default_device(cpu):
                yield

    # ------------------------------------------------------------------
    # Host-side exact CRT (any modulus level — mod-switched cts decrypt
    # at fewer limbs than the context's full L)
    # ------------------------------------------------------------------
    @functools.lru_cache(maxsize=None)
    def q_prod(self, level: int) -> int:
        """Product of the first `level` ciphertext moduli."""
        p = 1
        for m in self.ct_moduli[:level]:
            p *= m
        return p

    @functools.lru_cache(maxsize=None)
    def _crt_consts(self, level: int):
        qbig = self.q_prod(level)
        punctured = [qbig // m for m in self.ct_moduli[:level]]
        inv = [
            pow(punctured[i] % m, -1, m)
            for i, m in enumerate(self.ct_moduli[:level])
        ]
        return qbig, punctured, inv

    def crt_lift(self, residues: np.ndarray) -> list[int]:
        """u64[L', N] RNS residues -> per-coefficient big ints in [0, q').

        The modulus level is inferred from the limb axis, so reduced
        (mod-switched) polynomials lift at their own q'.
        """
        residues = np.asarray(residues)
        level = residues.shape[0]
        qbig, punctured, inv = self._crt_consts(level)
        out = [0] * residues.shape[-1]
        for i, m in enumerate(self.ct_moduli[:level]):
            row = residues[i].astype(object)
            contrib = (row * inv[i]) % m
            qi = punctured[i]
            for c in range(len(out)):
                out[c] = (out[c] + int(contrib[c]) * qi) % qbig
        return out


# process-wide context memo (see PirContext.for_params)
_CONTEXT_CACHE: "dict[PirParams, PirContext]" = {}

"""Slow, obviously-correct reference model for property tests.

Pure Python big-int math — the ground truth that the vectorized JAX kernels
are validated against (the role SEAL itself plays for the reference's test
suite, which runs real crypto at small parameters; SURVEY §4).
"""

from __future__ import annotations

import numpy as np


def negacyclic_mul(a, b, q: int):
    """Schoolbook product of integer coefficient lists mod (x^N + 1, q)."""
    n = len(a)
    assert len(b) == n
    out = [0] * n
    for i in range(n):
        ai = int(a[i])
        if ai == 0:
            continue
        for j in range(n):
            k = i + j
            prod = ai * int(b[j])
            if k < n:
                out[k] = (out[k] + prod) % q
            else:
                out[k - n] = (out[k - n] - prod) % q
    return [x % q for x in out]


def slow_negacyclic_ntt(a, psi: int, q: int):
    """Definition-level negacyclic NTT: hat_a[j] = sum_i a_i psi^{(2j+1) i}."""
    n = len(a)
    out = []
    for j in range(n):
        root = pow(psi, 2 * j + 1, q)
        acc = 0
        p = 1
        for i in range(n):
            acc = (acc + int(a[i]) * p) % q
            p = p * root % q
        out.append(acc)
    return out


def automorphism(a, galois_elt: int, q: int):
    """x -> x^g on a coefficient list mod (x^N + 1, q)."""
    n = len(a)
    out = [0] * n
    for i in range(n):
        j = (i * galois_elt) % (2 * n)
        if j < n:
            out[j] = (out[j] + int(a[i])) % q
        else:
            out[j - n] = (out[j - n] - int(a[i])) % q
    return out


def negacyclic_monomial_shift(a, index: int, q: int):
    """a * x^index mod (x^N + 1, q), index in [0, 2N)."""
    n = len(a)
    out = [0] * n
    for i in range(n):
        j = (i + index) % (2 * n)
        if j < n:
            out[j] = (out[j] + int(a[i])) % q
        else:
            out[j - n] = (out[j - n] - int(a[i])) % q
    return out


def crt_reconstruct(residues, moduli) -> list[int]:
    """Per-coefficient CRT: residues [L][N] -> big ints mod prod(moduli)."""
    q = 1
    for m in moduli:
        q *= int(m)
    n = len(residues[0])
    out = [0] * n
    for li, m in enumerate(moduli):
        m = int(m)
        qi = q // m
        inv = pow(qi % m, -1, m)
        for c in range(n):
            out[c] = (out[c] + int(residues[li][c]) * inv % m * qi) % q
    return out


def to_rns(coeffs, moduli) -> np.ndarray:
    """Big-int coefficient list -> u64[L, N] residue matrix."""
    out = np.zeros((len(moduli), len(coeffs)), dtype=np.uint64)
    for li, m in enumerate(moduli):
        for c, v in enumerate(coeffs):
            out[li, c] = int(v) % int(m)
    return out


def ntt_points(a, psi: int, q: int, ks) -> list[int]:
    """hat_a[k] = sum_i a_i psi^{(2k+1) i} mod q at the given k only (the
    definition of slow_negacyclic_ntt, for spot checks at large N)."""
    out = []
    for k in ks:
        root = pow(psi, 2 * int(k) + 1, q)
        acc = 0
        p = 1
        for ai in a:
            acc = (acc + int(ai) * p) % q
            p = p * root % q
        out.append(acc)
    return out


def dot_mod(xs, ys, q: int) -> int:
    """sum_j xs[j] * ys[j] mod q in big-int arithmetic."""
    return sum(int(x) * int(y) for x, y in zip(xs, ys)) % q

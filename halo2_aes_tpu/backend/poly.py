"""Polynomial layer: domains, coset extension, vanishing division, evals.

Role of halo2's poly/ module (EvaluationDomain, coset FFT, vanishing
argument support; SURVEY.md section 2.13 item 3).  Everything here is
Fr limb tensors on device; coefficient<->evaluation moves are NTTs.

Coset convention: the extended evaluation coset is {g * w_ext^i} with
g = the Fr multiplicative generator (7).  g is outside every power-of-2
subgroup, so X^n - 1 never vanishes on the coset.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from halo2_aes_tpu.ops import field as F
from halo2_aes_tpu.ops.ntt import Domain, domain, ntt_many

FR = F.FR
GEN = 7  # Fr multiplicative generator (coset shift)


@functools.lru_cache(maxsize=None)
def _shift_powers_np(k: int, inverse: bool):
    base = pow(GEN, -1, FR.modulus) if inverse else GEN
    return FR.host_powers(base, 1 << k)


def _shift_powers(k: int, inverse: bool):
    # numpy cached; fresh jnp constant per call site (trace-safe)
    return jnp.asarray(_shift_powers_np(k, inverse))


def to_coeffs(dom: Domain, evals):
    # ntt_many(count=1) == ntt, plus the NTT group routing gate
    return ntt_many(dom, evals, 1, inverse=True)


def to_evals(dom: Domain, coeffs):
    return ntt_many(dom, coeffs, 1)


def pad_coeffs(coeffs, n: int):
    m = coeffs.shape[0]
    if m == n:
        return coeffs
    return jnp.concatenate([coeffs, jnp.zeros((n - m, F.LIMBS), jnp.uint32)])


def coset_evals(dom_ext: Domain, coeffs):
    """Evaluate coeffs (m <= ext_n) on the coset {g * w_ext^i}."""
    c = pad_coeffs(coeffs, dom_ext.n)
    return ntt_many(dom_ext, c, 1,
                    shift_pows=_shift_powers(dom_ext.k, False))


def coset_interp(dom_ext: Domain, evals):
    """Inverse of coset_evals: coset evaluations -> coefficients."""
    c = ntt_many(dom_ext, evals, 1, inverse=True)
    return F.mont_mul(FR, c, _shift_powers(dom_ext.k, True))


@functools.lru_cache(maxsize=None)
def _vanishing_inv_table_np(k: int, ext_k: int):
    """(ratio, LIMBS) Montgomery inverses of Z_H on the coset.

    Z_H(g*w_ext^i) = g^n * w_ext^(n*i) - 1 cycles with period
    ratio = 2^(ext_k - k)."""
    p = FR.modulus
    n = 1 << k
    ratio = 1 << (ext_k - k)
    w_ext = domain(FR, ext_k).omega
    gn = pow(GEN, n, p)
    wn = pow(w_ext, n, p)
    vals = []
    acc = gn
    for _ in range(ratio):
        vals.append(pow(acc - 1, -1, p))
        acc = acc * wn % p
    return FR.encode(vals)


def divide_by_vanishing(k: int, dom_ext: Domain, evals_ext):
    """Pointwise divide coset evaluations by Z_H(X) = X^n - 1."""
    table = jnp.asarray(_vanishing_inv_table_np(k, dom_ext.k))
    idx = jnp.arange(dom_ext.n, dtype=jnp.int32) & (table.shape[0] - 1)
    return F.mont_mul(FR, evals_ext, jnp.take(table, idx, axis=0))


def rotate_ext(evals_ext, rot: int, ratio: int):
    """Rotation by w^rot on base domain == roll by rot*ratio on extended."""
    return jnp.roll(evals_ext, -rot * ratio, axis=0) if rot else evals_ext


def eval_at(coeffs, x: int):
    """Evaluate one or many coefficient polys at plain int x -> plain ints.

    coeffs: (..., m, LIMBS) Montgomery.  Host-returns python ints."""
    m = coeffs.shape[-2]
    pw = jnp.asarray(FR.host_powers(x, m))
    prod = F.mont_mul(FR, coeffs, pw)
    return FR.decode(F.tree_sum(FR, prod, axis=-2))


# --------------------------------------------------------------------------
# host scalar helpers (verifier side)
# --------------------------------------------------------------------------

def lagrange_evals_host(k: int, x: int, rows) -> list:
    """l_j(x) for the given row indices: l_j(x) = w^j (x^n - 1) / (n (x - w^j))."""
    p = FR.modulus
    n = 1 << k
    w = domain(FR, k).omega
    zh = (pow(x, n, p) - 1) % p
    n_inv = pow(n, -1, p)
    out = []
    for j in rows:
        wj = pow(w, j % n, p)
        out.append(wj * zh % p * pow((x - wj) % p, -1, p) % p * n_inv % p)
    return out


def vanishing_poly_coeffs(points) -> list:
    """Z(X) = prod (X - t) as plain-int coefficient list, low to high."""
    coeffs = [1]
    for t in points:
        nxt = [0] * (len(coeffs) + 1)
        for i, c in enumerate(coeffs):
            nxt[i + 1] = (nxt[i + 1] + c) % FR.modulus
            nxt[i] = (nxt[i] - c * t) % FR.modulus
        coeffs = nxt
    return coeffs


def eval_host(coeffs, x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % FR.modulus
    return acc


def lagrange_interp_host(points, evals) -> list:
    """Coefficients (plain ints, low->high) of the unique poly through
    (points[i], evals[i]); len <= 4 here."""
    p = FR.modulus
    coeffs = [0] * len(points)
    for i, (xi, yi) in enumerate(zip(points, evals)):
        basis = [1]
        denom = 1
        for j, xj in enumerate(points):
            if j == i:
                continue
            nxt = [0] * (len(basis) + 1)
            for d, c in enumerate(basis):
                nxt[d + 1] = (nxt[d + 1] + c) % p
                nxt[d] = (nxt[d] - c * xj) % p
            basis = nxt
            denom = denom * (xi - xj) % p
        scale = yi * pow(denom, -1, p) % p
        for d, c in enumerate(basis):
            coeffs[d] = (coeffs[d] + c * scale) % p
    return coeffs

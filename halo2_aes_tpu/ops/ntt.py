"""Number-theoretic transform over BN254 Fr, vectorized over the batch.

Replaces the rayon-parallel best_fft of the reference's proving backend
(SURVEY.md section 2.13 item 3: coset NTT for the quotient polynomial).

Design: radix-2 decimation-in-time with a host-precomputed bit-reversal
gather and per-stage twiddle tables that are built *on device* via
log-depth power doubling (ops/field.powers).  Every stage is one
batched field multiply + add/sub over (n/2) butterflies — no scalar
loops, static shapes, scan-free.

Domains are cached per (field, k).  Coset (extended-domain) transforms
distribute powers of the multiplicative generator before the NTT, as in
halo2's coset FFT.
"""

from __future__ import annotations

import functools

import jax

import jax.numpy as jnp
import numpy as np

from halo2_aes_tpu.ops import field as F


def _bitrev_perm(k: int) -> np.ndarray:
    n = 1 << k
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int32)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


class Domain:
    """Multiplicative subgroup of order 2^k with device twiddle tables."""

    def __init__(self, spec: F.FieldSpec, k: int):
        assert k <= spec.two_adicity
        self.spec = spec
        self.k = k
        self.n = 1 << k
        p = spec.modulus
        self.omega = pow(spec.root_of_unity(), 1 << (spec.two_adicity - k), p)
        self.omega_inv = pow(self.omega, -1, p)
        self.n_inv = pow(self.n, -1, p)
        self._bitrev_np = _bitrev_perm(k)
        self._tw = {}

    @property
    def bitrev(self):
        # numpy cached, converted per use: caching a jnp array created
        # inside a jit trace would leak a tracer into later traces
        return jnp.asarray(self._bitrev_np)

    def _twiddles(self, inverse: bool):
        """Full power table w^j, j < n/2 (w = omega or omega^-1).

        Host-computed (python bigints + bulk limb conversion): building
        these on device would compile log(n) differently-shaped multiply
        kernels at several seconds each on XLA CPU.
        """
        key = inverse
        if key not in self._tw:
            base = self.omega_inv if inverse else self.omega
            self._tw[key] = self.spec.host_powers(base, max(1, self.n // 2))
        return jnp.asarray(self._tw[key])

    def omega_powers(self, count=None, inverse: bool = False):
        """[1, w, w^2, ...] device table (count defaults to n)."""
        key = ("pow", inverse, count or self.n)
        if key not in self._tw:
            base = self.omega_inv if inverse else self.omega
            self._tw[key] = self.spec.host_powers(base, count or self.n)
        return jnp.asarray(self._tw[key])

    def bitrev_flat(self, count: int):
        """Bit-reversal gather indices for `count` polys stored FLAT
        (count*n rows): tile the per-poly table, offset by poly base."""
        key = ("bitrev_flat", count)
        if key not in self._tw:
            off = np.repeat(
                np.arange(count, dtype=np.int32) * self.n, self.n)
            self._tw[key] = (np.tile(self._bitrev_np, count).astype(np.int32)
                             + off)
        return jnp.asarray(self._tw[key])


@functools.lru_cache(maxsize=None)
def domain(spec: F.FieldSpec, k: int) -> Domain:
    return Domain(spec, k)


def ntt(dom: Domain, x, inverse: bool = False):
    """In-order NTT of x (n, ..., LIMBS) along axis 0 — jitted per domain
    so eager call sites reuse one compiled transform."""
    return _ntt_jit(dom, inverse, x.ndim)(x)


def ntt_flat(dom: Domain, x, count: int, inverse: bool = False):
    """`count` independent size-n NTTs over a FLAT (count*n, LIMBS)
    tensor (poly i at rows [i*n, (i+1)*n)) — ONE batched butterfly
    lattice instead of `count` sequential transforms.

    Works because every stage's index math (j, jh, lo/hi partner,
    twiddle index) only touches the low k bits of the row counter, and
    the per-poly base occupies strictly higher bits; only the initial
    bit-reversal gather needs per-poly offsets (Domain.bitrev_flat)."""
    return _ntt_jit(dom, inverse, x.ndim, count)(x)


@functools.lru_cache(maxsize=None)
def _ntt_jit(dom: Domain, inverse: bool, ndim: int, count: int = 1):
    return jax.jit(
        functools.partial(_ntt_impl, dom, inverse=inverse, count=count))


def _ntt_impl(dom: Domain, x, inverse: bool = False, count: int = 1):
    """In-order NTT of x (count*n, LIMBS): coeffs->evals (or
    evals->coeffs), batched over `count` polys stored flat.

    The stage loop is a lax.fori_loop whose body computes butterfly
    partners and twiddle indices arithmetically from the stage counter,
    so the traced graph is ONE stage regardless of k (compile time would
    otherwise scale with k * batch; measured 500s+ for an unrolled k=10
    on XLA CPU).  Each element gathers its partner, so the multiply is
    done for both halves (2x redundant) — a deliberate trade of
    arithmetic for constant graph size.
    """
    spec = dom.spec
    n = dom.n
    k = dom.k
    assert x.shape[0] == count * n
    if count == 1:
        x = jnp.take(x, dom.bitrev, axis=0)
    else:
        x = jnp.take(x, dom.bitrev_flat(count), axis=0)
    tw_full = dom._twiddles(inverse)
    o = jnp.arange(count * n, dtype=jnp.int32)

    def stage(s, x):
        m = jnp.int32(1) << s
        half = m >> 1
        j = o & (m - 1)
        jh = j & (half - 1)
        lo_idx = (o - j) + jh
        hi_idx = lo_idx + half
        tw_idx = jh << (k - s)          # jh * (n // m)
        lo = jnp.take(x, lo_idx, axis=0)
        hi = jnp.take(x, hi_idx, axis=0)
        tw = jnp.take(tw_full, tw_idx, axis=0)
        # the one multiply per stage
        t = F.mont_mul(spec, hi, tw)
        upper = (j >= half)[:, None]
        return jnp.where(upper, F.sub(spec, lo, t), F.add(spec, lo, t))

    x = jax.lax.fori_loop(1, k + 1, stage, x)
    if inverse:
        n_inv = jnp.asarray(spec.encode(dom.n_inv))
        x = F.mont_mul(spec, x, n_inv)
    return x


# max rows (count * n) per batched-NTT group: butterfly temps are ~5
# live (rows, 16) u32 tensors, so 2^22 rows keeps one group's working
# set ~1.3 GB — wide enough to amortize launches, small enough for the
# k=20 phase budgets.
NTT_GROUP_ROWS = 1 << 22


def _group_rows() -> int:
    """Per-group row budget: wide on an accelerator (launch
    amortization), narrow on CPU where a multi-poly lattice's per-stage
    working set (rows * 64 B * ~5 live temps) falls out of the last-level
    cache and costs ~3x wall clock (k=17 keygen on a one-core host)."""
    return (1 << 17) if jax.default_backend() == "cpu" else NTT_GROUP_ROWS


def ntt_many(dom: Domain, flat, count: int, inverse: bool = False,
             shift_pows=None):
    """``count`` batched size-n transforms over a FLAT (count*n, LIMBS)
    tensor (poly i at rows [i*n, (i+1)*n)), grouped into flat batched
    lattices (ntt_flat) of at most NTT_GROUP_ROWS rows each so butterfly
    temps stay bounded; ``shift_pows`` (n, LIMBS) multiplies every poly
    onto a coset first.  Jittable (trace-safe); used by both the prover
    phases and keygen."""
    n = dom.n
    spec = dom.spec
    if shift_pows is not None:
        flat = F.mont_mul(spec, flat, jnp.tile(shift_pows, (count, 1)))
    if count == 1:
        return ntt(dom, flat, inverse=inverse)

    def transform(fl, g):
        return ntt_flat(dom, fl, g, inverse=inverse)

    Gmax = max(1, min(count, _group_rows() // n))
    groups = -(-count // Gmax)
    # balance the group size: 40 polys with Gmax=32 should run as 2x20,
    # not 32 + 8-plus-24-zero-pads (the pad rows are full transforms)
    G = -(-count // groups)
    pad = groups * G - count
    if pad:
        flat = jnp.concatenate(
            [flat, jnp.zeros((pad * n, F.LIMBS), jnp.uint32)])
    if groups == 1:
        out = transform(flat, G)
    else:
        def body(i, out):
            sl = jax.lax.dynamic_slice(
                flat, (i * G * n, 0), (G * n, F.LIMBS))
            return jax.lax.dynamic_update_slice(
                out, transform(sl, G), (i * G * n, 0))

        out = jax.lax.fori_loop(0, groups, body, jnp.zeros_like(flat))
    return out[: count * n] if pad else out


def coset_ntt(dom: Domain, coeffs, shift_powers):
    """Evaluate coeffs on the coset {shift * w^i}: distribute then NTT."""
    return ntt(dom, F.mont_mul(dom.spec, coeffs, shift_powers))


def coset_intt(dom: Domain, evals, shift_inv_powers):
    """Inverse of coset_ntt."""
    return F.mont_mul(dom.spec, ntt(dom, evals, inverse=True), shift_inv_powers)


def eval_poly(spec: F.FieldSpec, coeffs, x):
    """Evaluate a coefficient-form polynomial at point x ((16,) Montgomery)."""
    pw = F.powers(spec, x, coeffs.shape[0])
    return F.dot(spec, coeffs, pw)

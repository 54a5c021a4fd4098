"""BN254 G1 arithmetic: batched homogeneous-projective point ops on Fq limbs.

Role of `halo2curves` bn256 G1 in the reference dependency tree
(reference Cargo.lock:779-781): the group the KZG commitment MSMs live
in.  Points are structure-of-arrays limb tensors
(X, Y, Z each ``(..., 16)`` uint32, Montgomery form) and every group
operation uses the Renes-Costello-Batina COMPLETE addition formulas for
a = 0 prime-order curves (eprint 2015/1060, algorithms 7 and 9):

  * exception-FREE — identity, doubling, and inverse cases all flow
    through the same 12-multiply dataflow, no selects, no branches, so
    the combiner drops straight into scans/loops/trees,
  * the 12 general-add multiplies schedule into exactly TWO stacked
    multiply stages (6 independent products each), minimizing both the
    traced graph and the sequential depth per add — less than half the
    cost of the Jacobian complete adder this replaces.

On the GPU ``add`` and ``double`` each run as one CUDA kernel
(ops/gpu_field.py) with the same dataflow; ``add_xla`` and
``double_xla`` are the plain XLA forms (built from the field module's
XLA forms), which run elsewhere and are the kernels' reference.

Curve: y^2 z = x^3 + 3 z^3 over Fq, prime order r (= Fr modulus).
Identity convention: Z == 0 (canonically (0 : 1 : 0); any (0 : y!=0 : 0)
representative is projectively equivalent and handled exactly).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from halo2_aes_tpu.ops import field as F

FQ = F.FQ
B_COEFF = 3
_B3 = 3 * B_COEFF  # b3 = 9 in the RCB formulas

# generator (halo2curves bn256 G1 generator)
G1_X = 1
G1_Y = 2


def identity(shape=()):
    z = F.zeros(shape)
    one = jnp.broadcast_to(jnp.asarray(FQ.one_mont), (*shape, F.LIMBS))
    return (z, one, z)


def is_identity(p):
    return F.is_zero(p[2])


def affine_to_jacobian(xy):
    """(x, y) Montgomery limb arrays -> projective with Z = 1.

    (Name kept from the Jacobian era; representation is homogeneous.)"""
    x, y = xy
    z = jnp.broadcast_to(jnp.asarray(FQ.one_mont), x.shape)
    return (x, y, z)


affine_to_proj = affine_to_jacobian


def neg(p):
    x, y, z = p
    return (x, F.neg(FQ, y), z)


def _bmul(pairs):
    """One stacked Montgomery multiply for independent products.

    pairs: list of (a, b) limb arrays with a common batch shape.  Batching
    keeps the traced graph small (one mul op instead of len(pairs)) and
    the device lanes wide."""
    a = jnp.stack([x for x, _ in pairs])
    b = jnp.stack([y for _, y in pairs])
    out = F.mont_mul_xla(FQ, a, b)
    return [out[i] for i in range(len(pairs))]


def _mul_b3(a):
    """9 * a via an add chain (8a + a): 4 vector adds, no multiply."""
    a2 = F.add_xla(FQ, a, a)
    a4 = F.add_xla(FQ, a2, a2)
    a8 = F.add_xla(FQ, a4, a4)
    return F.add_xla(FQ, a8, a)


def add(p, q):
    """RCB complete addition (one kernel on the GPU, else ``add_xla``)."""
    from halo2_aes_tpu.ops import gpu_field

    if gpu_field.use_kernels():
        return gpu_field.g1_add(p, q)
    return add_xla(p, q)


def double(p):
    """RCB complete doubling (one kernel on the GPU, else ``double_xla``)."""
    from halo2_aes_tpu.ops import gpu_field

    if gpu_field.use_kernels():
        return gpu_field.g1_double(p)
    return double_xla(p)


@jax.jit
def add_xla(p, q):
    """RCB complete addition (alg. 7, a=0, b3=9): handles identity on
    either side, P + P, and P + (-P) with NO branches or selects.

    12 field multiplies in two stacked stages + cheap add chains.
    """
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    fadd = lambda a, b: F.add_xla(FQ, a, b)  # noqa: E731
    fsub = lambda a, b: F.sub_xla(FQ, a, b)  # noqa: E731

    t0, t1, t2, A, B, C = _bmul([
        (X1, X2), (Y1, Y2), (Z1, Z2),
        (fadd(X1, Y1), fadd(X2, Y2)),
        (fadd(Y1, Z1), fadd(Y2, Z2)),
        (fadd(X1, Z1), fadd(X2, Z2)),
    ])
    t3 = fsub(fsub(A, t0), t1)          # X1Y2 + X2Y1
    t4 = fsub(fsub(B, t1), t2)          # Y1Z2 + Y2Z1
    xz = fsub(fsub(C, t0), t2)          # X1Z2 + X2Z1
    t0_3 = fadd(fadd(t0, t0), t0)       # 3 X1X2
    t2_b = _mul_b3(t2)                  # b3 Z1Z2
    z3t = fadd(t1, t2_b)
    t1m = fsub(t1, t2_b)
    y3b = _mul_b3(xz)                   # b3 (X1Z2 + X2Z1)

    X3a, X3b, Y3a, Y3b, Z3a, Z3b = _bmul([
        (t4, y3b), (t3, t1m), (y3b, t0_3), (t1m, z3t), (z3t, t4), (t0_3, t3),
    ])
    X3 = fsub(X3b, X3a)
    Y3 = fadd(Y3b, Y3a)
    Z3 = fadd(Z3a, Z3b)
    return (X3, Y3, Z3)


@jax.jit
def double_xla(p):
    """RCB complete doubling (alg. 9, a=0, b3=9).  Identity-safe.

    8 field multiplies in two stacked stages."""
    X, Y, Z = p
    fadd = lambda a, b: F.add_xla(FQ, a, b)  # noqa: E731
    fsub = lambda a, b: F.sub_xla(FQ, a, b)  # noqa: E731

    t0, t1, t2, t3 = _bmul([(Y, Y), (Y, Z), (Z, Z), (X, Y)])
    z8 = fadd(t0, t0)
    z8 = fadd(z8, z8)
    z8 = fadd(z8, z8)                    # 8 Y^2
    t2b = _mul_b3(t2)                    # b3 Z^2
    y3s = fadd(t0, t2b)
    t2b3 = fadd(fadd(t2b, t2b), t2b)     # 3 b3 Z^2
    t0m = fsub(t0, t2b3)

    X3a, Z3, Y3a, X3b = _bmul([(t2b, z8), (t1, z8), (t0m, y3s), (t0m, t3)])
    Y3 = fadd(X3a, Y3a)
    X3 = fadd(X3b, X3b)
    return (X3, Y3, Z3)


def to_affine_host(p) -> list:
    """Batched projective (device/host limbs) -> list of (x, y) python
    ints (plain form), identity -> None.  Host-side; for tests and
    transcripts."""
    X, Y, Z = (np.asarray(c) for c in p)
    X = X.reshape(-1, F.LIMBS)
    Y = Y.reshape(-1, F.LIMBS)
    Z = Z.reshape(-1, F.LIMBS)
    out = []
    q = FQ.modulus
    for i in range(X.shape[0]):
        z = FQ.from_mont_host(F.limbs_to_int(Z[i]))
        if z == 0:
            out.append(None)
            continue
        x = FQ.from_mont_host(F.limbs_to_int(X[i]))
        y = FQ.from_mont_host(F.limbs_to_int(Y[i]))
        zinv = pow(z, -1, q)
        out.append((x * zinv % q, y * zinv % q))
    return out


def affine_from_ints(points) -> tuple:
    """List of (x, y) python ints (plain) -> batched affine limb arrays
    (Montgomery).  Identity entries are not representable here; filter
    them before encoding."""
    xs = FQ.encode([x for x, _ in points])
    ys = FQ.encode([y for _, y in points])
    return jnp.asarray(xs), jnp.asarray(ys)


# ---------------------------------------------------------------------------
# host oracle (python bigints) — for tests and host-side setup
# ---------------------------------------------------------------------------

def py_add(p, q, mod=FQ.modulus):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if (y1 + y2) % mod == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, -1, mod) % mod
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, mod) % mod
    x3 = (lam * lam - x1 - x2) % mod
    y3 = (lam * (x1 - x3) - y1) % mod
    return (x3, y3)


def py_mul(p, k: int):
    acc = None
    while k:
        if k & 1:
            acc = py_add(acc, p)
        p = py_add(p, p)
        k >>= 1
    return acc


def host_msm(points, scalars):
    """sum_i scalars[i] * points[i] on host (affine int pairs, None =
    identity).  Routes through the native C++ backend when available
    (halo2_aes_tpu.native — the verifier's hot path), else folds with
    the python-bigint oracle."""
    from halo2_aes_tpu import native

    if native.available():
        return native.g1_msm(points, [int(s) % F.FR.modulus for s in scalars])
    acc = None
    for p, s in zip(points, scalars):
        s = int(s) % F.FR.modulus
        if p is None or s == 0:
            continue
        acc = py_add(acc, p if s == 1 else py_mul(p, s))
    return acc


def py_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    q = FQ.modulus
    return (y * y - x * x * x - B_COEFF) % q == 0

"""Prime-field arithmetic: fixed-width limb vectors + Montgomery mul.

This is the foundation layer of the halo2-style proving stack (role of
`ff`/`halo2curves` field arithmetic in the reference dependency tree,
see reference Cargo.lock:558-560, 779-781).

Design:
  * A field element is a little-endian vector of 16 limbs x 16 bits stored
    in ``uint32`` lanes: shape ``(..., 16)``.  16x16->32-bit products fit
    exactly in a uint32 lane, and every op vectorizes over the leading
    (batch) axes.
  * Multiplication is Montgomery (R = 2^256) with a redundant-limb
    accumulator: partial products are split into lo/hi 16-bit halves and
    accumulated in uint32 columns (bounded < 2^23, no overflow), so carry
    propagation happens only once at the end.
  * On the GPU, BN254 Fr and Fq operations run as CUDA kernels
    (ops/gpu_field.py).  Elsewhere the XLA forms below run; their graphs
    stay small: a multiply is a 16-step fori_loop and every carry chain
    a loop-free log-depth carry-lookahead.
  * Batch inversion uses two ``associative_scan`` cumulative products +
    one Fermat inversion, replacing the sequential loop a CPU
    implementation would use.

Unless stated otherwise every function takes/returns values in Montgomery
form and canonical range [0, p).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

LIMBS = 16
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
NBITS = LIMBS * LIMB_BITS  # 256


# ---------------------------------------------------------------------------
# host-side helpers (python ints <-> limb arrays)
# ---------------------------------------------------------------------------

def int_to_limbs(x: int) -> np.ndarray:
    """Python int -> uint32[16] little-endian 16-bit limbs (plain form)."""
    assert 0 <= x < (1 << NBITS)
    return np.array([(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(LIMBS)],
                    dtype=np.uint32)


def ints_to_limbs(xs) -> np.ndarray:
    """Iterable of python ints -> uint32[n, 16]."""
    return np.stack([int_to_limbs(int(x)) for x in xs])


def ints_to_limbs_fast(xs) -> np.ndarray:
    """Bulk python ints -> uint32[n,16] via bytes (no per-limb loop)."""
    buf = b"".join(int(x).to_bytes(32, "little") for x in xs)
    u16 = np.frombuffer(buf, dtype="<u2").reshape(len(xs), LIMBS)
    return u16.astype(np.uint32)


def limbs_to_int(a) -> int:
    """uint32[16] -> python int."""
    a = np.asarray(a, dtype=np.uint64)
    return sum(int(a[i]) << (LIMB_BITS * i) for i in range(LIMBS))


def limbs_to_ints(a) -> list:
    a = np.asarray(a)
    flat = a.reshape(-1, LIMBS)
    return [limbs_to_int(r) for r in flat]


# ---------------------------------------------------------------------------
# Field specification
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FieldSpec:
    """All host-precomputed constants for one prime field.

    Hash/equality use only the scalar fields, so a FieldSpec can be a
    static jit argument and an lru_cache key.  The jnp constant arrays are
    materialized lazily per call site; numpy versions are kept here so
    layout/keygen code can run host-side.
    """

    name: str
    modulus: int
    # multiplicative generator & 2-adicity (for NTT domains); 0 if unused
    generator: int = 0
    two_adicity: int = 0

    # derived, filled in __post_init__
    p_limbs: np.ndarray = field(init=False, repr=False, compare=False)
    r_mod_p: int = field(init=False, compare=False)   # R mod p (Montgomery ONE)
    r2_mod_p: int = field(init=False, compare=False)  # R^2 mod p
    n0inv: int = field(init=False, compare=False)     # -p^-1 mod 2^16
    one_mont: np.ndarray = field(init=False, repr=False, compare=False)
    r2_limbs: np.ndarray = field(init=False, repr=False, compare=False)
    p_comp_limbs: np.ndarray = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        p = self.modulus
        R = 1 << NBITS
        object.__setattr__(self, "p_limbs", int_to_limbs(p))
        object.__setattr__(self, "r_mod_p", R % p)
        object.__setattr__(self, "r2_mod_p", (R * R) % p)
        object.__setattr__(self, "n0inv", (-pow(p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS))
        object.__setattr__(self, "one_mont", int_to_limbs(R % p))
        object.__setattr__(self, "r2_limbs", int_to_limbs((R * R) % p))
        object.__setattr__(self, "p_comp_limbs", int_to_limbs(R - p))

    # -- host conversions ----------------------------------------------------
    def to_mont_host(self, x: int) -> int:
        return (x << NBITS) % self.modulus

    def from_mont_host(self, x: int) -> int:
        return (x * pow(1 << NBITS, -1, self.modulus)) % self.modulus

    def encode(self, xs) -> np.ndarray:
        """Python ints (plain) -> limb array in Montgomery form."""
        if isinstance(xs, int):
            return int_to_limbs(self.to_mont_host(xs % self.modulus))
        return ints_to_limbs_fast([self.to_mont_host(int(x) % self.modulus) for x in xs])

    def host_powers(self, base: int, count: int) -> np.ndarray:
        """uint32[count,16] Montgomery powers table, computed with python
        bigints (one host multiply per entry — faster than compiling
        device doubling chains, and cacheable)."""
        p = self.modulus
        out = []
        acc = 1
        bm = base % p
        for _ in range(count):
            out.append(self.to_mont_host(acc))
            acc = (acc * bm) % p
        return ints_to_limbs_fast(out)

    def decode(self, a) -> list:
        """Limb array (Montgomery form) -> list of plain python ints."""
        return [self.from_mont_host(v) for v in limbs_to_ints(a)]

    def root_of_unity(self) -> int:
        """Primitive 2^two_adicity-th root of unity (plain int)."""
        assert self.two_adicity > 0
        return pow(self.generator, (self.modulus - 1) >> self.two_adicity, self.modulus)


# BN254 scalar field (Fr) and base field (Fq).  Same curve as the reference
# (halo2curves bn256, reference Cargo.lock:779-781).
FR_MODULUS = 21888242871839275222246405745257275088548364400416034343698204186575808495617
FQ_MODULUS = 21888242871839275222246405745257275088696311157297823662689037894645226208583

FR = FieldSpec("bn254_fr", FR_MODULUS, generator=7, two_adicity=28)
FQ = FieldSpec("bn254_fq", FQ_MODULUS)


# ---------------------------------------------------------------------------
# core limb kernels (jnp, shape (..., 16), uint32)
# ---------------------------------------------------------------------------

_U32 = jnp.uint32


def _mask():
    return _U32(LIMB_MASK)


def zeros(shape=()) -> jnp.ndarray:
    return jnp.zeros((*shape, LIMBS), dtype=_U32)


def _dus_add(acc, v, start):
    """acc[..., start : start+v.shape[-1]] += v (dynamic start index)."""
    seg = jax.lax.dynamic_slice_in_dim(acc, start, v.shape[-1], axis=-1)
    return jax.lax.dynamic_update_slice_in_dim(acc, seg + v, start, axis=-1)


def _shift_up(x, d: int):
    """x[..., i - d] along the limb axis, zeros shifted in at the bottom."""
    pad = [(0, 0)] * (x.ndim - 1) + [(d, 0)]
    return jnp.pad(x[..., : x.shape[-1] - d], pad)


def _carry_norm(acc, out_limbs=LIMBS):
    """Propagate carries: redundant limbs (<2^32) -> canonical 16-bit
    limbs of the value mod 2^(16m).  ``acc`` has shape (..., m); returns
    (..., out_limbs).

    Loop-free: one split moves every limb's high half up a limb (leaving
    limbs < 2^17, so each carry is 0 or 1), then a Kogge-Stone prefix
    over (generate, propagate) bits resolves the ripple in
    ceil(log2 m) vectorized rounds.
    """
    m = acc.shape[-1]
    mask = _mask()
    s = (acc & mask) + _shift_up(acc >> LIMB_BITS, 1)   # < 2^17 - 1
    t = s & mask
    gen = s >> LIMB_BITS                    # carry out regardless of c
    prop = (t == mask).astype(_U32)         # carry out iff carry in
    d = 1
    while d < m:
        gen = gen | (prop & _shift_up(gen, d))
        prop = prop & _shift_up(prop, d)
        d *= 2
    return ((t + _shift_up(gen, 1)) & mask)[..., :out_limbs]


def _add_raw(a, b):
    """(a + b) over 16 limbs; returns (sum_limbs, carry_out).  a + b never
    overflows u32 columns: one redundant add + carry pass."""
    bshape = jnp.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    s = jnp.broadcast_to(a, (*bshape, LIMBS)) + jnp.broadcast_to(b, (*bshape, LIMBS))
    wide = jnp.concatenate([s, jnp.zeros((*bshape, 1), _U32)], axis=-1)
    out = _carry_norm(wide, LIMBS + 1)
    return out[..., :LIMBS], out[..., LIMBS]


def _sub_raw(a, b):
    """(a - b) over 16 limbs; returns (diff, borrow_out).

    Biased redundant form: a_i + (2^16 - 1) - b_i + 1 at limb 0 keeps
    every column in [0, 2^17); the carry pass then yields a - b + 2^256,
    whose top carry bit is the NOT-borrow flag."""
    bshape = jnp.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    bias = jnp.full((*bshape, LIMBS), LIMB_MASK, _U32)
    s = jnp.broadcast_to(a, (*bshape, LIMBS)) + bias - jnp.broadcast_to(b, (*bshape, LIMBS))
    s = s.at[..., 0].add(1)
    wide = jnp.concatenate([s, jnp.zeros((*bshape, 1), _U32)], axis=-1)
    out = _carry_norm(wide, LIMBS + 1)
    return out[..., :LIMBS], _U32(1) - out[..., LIMBS]


def _cond_sub_p(spec: FieldSpec, a):
    """Return a mod p for a in [0, 2p). One subtraction + select."""
    p = jnp.asarray(spec.p_limbs)
    d, borrow = _sub_raw(a, p)
    ge = (borrow == 0)[..., None]
    return jnp.where(ge, d, a)


# The plain XLA forms of the four basic operations.  They run wherever
# the CUDA kernels do not (ops/gpu_field.py: BN254 Fr and Fq on the
# GPU), and they are the reference the kernels are checked against.

def add_xla(spec: FieldSpec, a, b):
    """Canonical modular addition."""
    s, carry = _add_raw(a, b)
    # a+b < 2p < 2^255 so carry==0 always for canonical inputs.
    del carry
    return _cond_sub_p(spec, s)


def sub_xla(spec: FieldSpec, a, b):
    """Canonical modular subtraction."""
    d, borrow = _sub_raw(a, b)
    p = jnp.asarray(spec.p_limbs)
    d_plus_p, _ = _add_raw(d, p)
    return jnp.where((borrow == 1)[..., None], d_plus_p, d)


def neg_xla(spec: FieldSpec, a):
    p = jnp.asarray(spec.p_limbs)
    d, _ = _sub_raw(p, a)
    # neg(0) must be 0, not p
    is_zero = jnp.all(a == 0, axis=-1, keepdims=True)
    return jnp.where(is_zero, jnp.zeros_like(d), d)


def mont_mul_xla(spec: FieldSpec, a, b):
    """Montgomery multiply: returns a*b*R^-1 mod p, canonical.

    Interleaved operand-scanning (CIOS) with a redundant uint32
    accumulator, vectorized over the limb axis: each of the 16 outer
    steps (one fori_loop step) is one 16-wide multiply plus slice-adds,
    so the traced graph stays small and every op is wide.  Bounds: every
    accumulator limb receives at most 16 lo + 16 hi halves from the
    product plus 16 lo + 16 hi from the reduction plus carries
    => < 2^23 << 2^32.
    """
    n = jnp.asarray(spec.p_limbs)  # (16,), broadcasts against (..., 1) * (16,)
    bshape = jnp.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    a = jnp.broadcast_to(a, (*bshape, LIMBS))
    b = jnp.broadcast_to(b, (*bshape, LIMBS))
    acc = jnp.zeros((*bshape, 2 * LIMBS + 1), dtype=_U32)
    mask = _mask()
    n0 = _U32(spec.n0inv)

    def step(i, acc):
        ai = jax.lax.dynamic_slice_in_dim(a, i, 1, axis=-1)
        t = ai * b
        acc = _dus_add(acc, t & mask, i)
        acc = _dus_add(acc, t >> LIMB_BITS, i + 1)
        acc_i = jax.lax.dynamic_slice_in_dim(acc, i, 1, axis=-1)
        m = (acc_i * n0) & mask
        q = m * n
        acc = _dus_add(acc, q & mask, i)
        acc = _dus_add(acc, q >> LIMB_BITS, i + 1)
        acc_i = jax.lax.dynamic_slice_in_dim(acc, i, 1, axis=-1)
        return _dus_add(acc, acc_i >> LIMB_BITS, i + 1)

    acc = jax.lax.fori_loop(0, LIMBS, step, acc)
    return _cond_sub_p(spec, _carry_norm(acc[..., LIMBS:], out_limbs=LIMBS))


# The public entry points below are jitted with the FieldSpec static:
# called eagerly, closure-free jit args hit the pjit cache per shape
# (an eager fori_loop would close over concrete arrays as jaxpr
# constants and recompile on every call).  The kernel choice is made at
# trace time from the backend.

def _kernels(spec: FieldSpec):
    from halo2_aes_tpu.ops import gpu_field

    return gpu_field if gpu_field.use_kernels(spec) else None


@functools.partial(jax.jit, static_argnums=0)
def add(spec: FieldSpec, a, b):
    """Canonical modular addition."""
    k = _kernels(spec)
    return k.add(spec, a, b) if k else add_xla(spec, a, b)


@functools.partial(jax.jit, static_argnums=0)
def sub(spec: FieldSpec, a, b):
    """Canonical modular subtraction."""
    k = _kernels(spec)
    return k.sub(spec, a, b) if k else sub_xla(spec, a, b)


@functools.partial(jax.jit, static_argnums=0)
def neg(spec: FieldSpec, a):
    k = _kernels(spec)
    return k.neg(spec, a) if k else neg_xla(spec, a)


@functools.partial(jax.jit, static_argnums=0)
def mont_mul(spec: FieldSpec, a, b):
    k = _kernels(spec)
    return k.mont_mul(spec, a, b) if k else mont_mul_xla(spec, a, b)


def mul(spec: FieldSpec, a, b):
    """Field multiply (both operands and result in Montgomery form)."""
    return mont_mul(spec, a, b)


def square(spec: FieldSpec, a):
    return mont_mul(spec, a, a)


def to_mont(spec: FieldSpec, a_plain):
    return mont_mul(spec, a_plain, jnp.asarray(spec.r2_limbs))


def from_mont(spec: FieldSpec, a):
    one = jnp.zeros_like(a).at[..., 0].set(1)
    return mont_mul(spec, a, one)


@functools.partial(jax.jit, static_argnums=(0, 2))
def pow_const(spec: FieldSpec, a, e: int):
    """a ** e for a fixed python-int exponent.

    Small exponents unroll statically; large ones run a fori_loop over
    the exponent bits so the traced graph contains just two multiplies.
    """
    if e == 0:
        return jnp.broadcast_to(jnp.asarray(spec.one_mont), a.shape)
    nbits = e.bit_length()
    if nbits <= 24:
        result = None
        base = a
        while e > 0:
            if e & 1:
                result = base if result is None else mont_mul(spec, result, base)
            e >>= 1
            if e:
                base = square(spec, base)
        return result

    bits = jnp.asarray(
        np.array([(e >> i) & 1 for i in range(nbits)], dtype=np.uint32)
    )
    one = jnp.broadcast_to(jnp.asarray(spec.one_mont), a.shape)

    def body(i, carry):
        result, base = carry
        hit = mont_mul(spec, result, base)
        result = jnp.where((bits[i] == 1)[..., None], hit, result)
        base = square(spec, base)
        return (result, base)

    result, _ = jax.lax.fori_loop(0, nbits, body, (one, a))
    return result


def inv(spec: FieldSpec, a):
    """Batched Fermat inversion a^(p-2). inv(0) = 0."""
    return pow_const(spec, a, spec.modulus - 2)


# associative_scan materializes interior-padded (dilated) temporaries
# whose XLA layout is 8x-expanded for (rows, 16) u32 tensors; above this
# row count the scan is blocked with a sequential carry so those temps
# stay bounded (a k=20 product phase scans 8.4M rows — unblocked, the
# pads alone are 3 x 4 GB and the phase cannot compile).
_SCAN_BLOCK = 1 << 19


def cumprod(spec: FieldSpec, a):
    """Inclusive cumulative product along axis 0, scan temps bounded."""
    return _cumprod_blocked(spec, a)


def _cumprod_blocked(spec: FieldSpec, a):
    n = a.shape[0]
    if n <= _SCAN_BLOCK:
        return jax.lax.associative_scan(
            lambda x, y: mont_mul(spec, x, y), a, axis=0)
    pieces = []
    carry = None
    for lo in range(0, n, _SCAN_BLOCK):
        chunk = a[lo : min(lo + _SCAN_BLOCK, n)]
        s = jax.lax.associative_scan(
            lambda x, y: mont_mul(spec, x, y), chunk, axis=0)
        if carry is not None:
            s = mont_mul(spec, s, carry)
        pieces.append(s)
        carry = s[-1]
    return jnp.concatenate(pieces, axis=0)


@functools.partial(jax.jit, static_argnums=(0, 2))
def cumprod_segmented(spec: FieldSpec, a, seg_len: int):
    """Per-segment inclusive cumulative product of flat (S*seg_len, 16):
    segment s occupies rows [s*seg_len, (s+1)*seg_len) and scans restart
    at each segment start.

    ONE flag-carrying associative scan over the whole flat tensor
    (combine: (f1,v1)x(f2,v2) -> (f1|f2, f2 ? v2 : v1*v2) — associative,
    so blocking composes the same way) instead of S separate scan
    chains: the per-lookup grand-product loop dispatched S*log(n) small
    kernels, the dominant serialized cost of the product phase at
    n_sets=4 (measured 42 s of an 81 s serialized k=17 prove)."""
    m = a.shape[0]
    assert m % seg_len == 0
    flags = (jnp.arange(m) % seg_len) == 0

    def comb(x, y):
        fx, vx = x
        fy, vy = y
        return (fx | fy, jnp.where(fy[:, None], vy, mont_mul(spec, vx, vy)))

    pieces = []
    carry = None
    for lo in range(0, m, _SCAN_BLOCK):
        hi = min(lo + _SCAN_BLOCK, m)
        fb, vb = flags[lo:hi], a[lo:hi]
        sf, sv = jax.lax.associative_scan(comb, (fb, vb), axis=0)
        if carry is not None:
            cf, cv = carry
            sv = jnp.where(sf[:, None], sv, mont_mul(spec, sv, cv))
            sf = sf | cf
        pieces.append(sv)
        carry = (sf[-1], sv[-1])
    return jnp.concatenate(pieces, axis=0) if len(pieces) > 1 else pieces[0]


@functools.partial(jax.jit, static_argnums=0)
def batch_inv(spec: FieldSpec, a):
    """Invert a batch (n, 16) with one field inversion + O(n) muls.

    Montgomery's trick, vectorized: two (blocked) cumulative products +
    one Fermat inversion + two elementwise muls.
    Zero entries map to zero (scan-safe: zeros are replaced by ONE and
    masked back at the end).
    """
    one = jnp.asarray(spec.one_mont)
    is_zero = jnp.all(a == 0, axis=-1, keepdims=True)
    a_safe = jnp.where(is_zero, one, a)

    fwd = _cumprod_blocked(spec, a_safe)                 # P_i = prod_{j<=i}
    rev = _cumprod_blocked(spec, a_safe[::-1])[::-1]     # S_i = prod_{j>=i}
    total_inv = inv(spec, fwd[-1])
    n = a.shape[0]
    # inv(a_i) = P_{i-1} * S_{i+1} * total_inv
    p_prev = jnp.concatenate([one[None], fwd[:-1]], axis=0)
    s_next = jnp.concatenate([rev[1:], one[None]], axis=0)
    out = mont_mul(spec, mont_mul(spec, p_prev, s_next), total_inv)
    return jnp.where(is_zero, jnp.zeros_like(out), out)


def powers(spec: FieldSpec, base, count: int):
    """[1, base, base^2, ..., base^(count-1)] via log-depth doubling.

    base: (16,) Montgomery form. Returns (count, 16). O(count) muls in
    O(log count) sequential steps — the scan-free way to build twiddle
    and challenge-power tables on device.
    """
    one = jnp.asarray(spec.one_mont)
    arr = one[None, :]
    cur = base
    while arr.shape[0] < count:
        arr = jnp.concatenate([arr, mont_mul(spec, arr, cur[None, :])], axis=0)
        cur = square(spec, cur)
    return arr[:count]


def tree_sum(spec: FieldSpec, a, axis: int = 0):
    """Modular sum along an axis via log-depth pairwise folding."""
    a = jnp.moveaxis(a, axis, 0)
    n = a.shape[0]
    while n > 1:
        half = n // 2
        lo, hi, rest = a[:half], a[half : 2 * half], a[2 * half :]
        a = jnp.concatenate([add(spec, lo, hi), rest], axis=0)
        n = a.shape[0]
    return a[0]


def dot(spec: FieldSpec, a, b):
    """Field inner product along the leading axis."""
    return tree_sum(spec, mont_mul(spec, a, b), axis=0)


def eq(a, b):
    return jnp.all(a == b, axis=-1)


def is_zero(a):
    return jnp.all(a == 0, axis=-1)


def select(cond, a, b):
    """cond broadcastable over batch shape (no limb axis)."""
    return jnp.where(cond[..., None], a, b)


# ---------------------------------------------------------------------------
# convenience: byte-value embedding (used by the AES circuit witness)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _byte_mont_table_np(spec: FieldSpec) -> np.ndarray:
    """uint32[256,16]: Montgomery form of 0..255."""
    return ints_to_limbs([spec.to_mont_host(v) for v in range(256)])


def bytes_to_field(spec: FieldSpec, b):
    """uint8/int array (...,) of byte values -> Montgomery limb array (...,16)."""
    table = jnp.asarray(_byte_mont_table_np(spec))
    return table[b.astype(jnp.int32)]


def u16_to_field(spec: FieldSpec, v):
    """Plain integer array with values < 2^16 -> Montgomery form (no table).

    Builds the plain limb vector [v,0,...] and multiplies by R^2.
    """
    lead = v.astype(_U32)[..., None]
    rest = jnp.zeros((*v.shape, LIMBS - 1), dtype=_U32)
    return to_mont(spec, jnp.concatenate([lead, rest], axis=-1))

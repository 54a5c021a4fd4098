"""Property tests for limb-vector field arithmetic vs python bigints.

Mirrors the role of the `ff`-level unit tests the reference relies on in
its dependency (reference SURVEY.md section 2.13); here we test against
an independent python-int oracle.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from halo2_aes_tpu.ops import field as F

RNG = random.Random(1234)


def rand_ints(spec, n):
    return [RNG.randrange(spec.modulus) for _ in range(n)]


@pytest.mark.parametrize("spec", [F.FR, F.FQ], ids=["fr", "fq"])
def test_roundtrip_encode_decode(spec):
    xs = rand_ints(spec, 8) + [0, 1, spec.modulus - 1]
    enc = spec.encode(xs)
    assert spec.decode(enc) == [x % spec.modulus for x in xs]


@pytest.mark.parametrize("spec", [F.FR, F.FQ], ids=["fr", "fq"])
def test_mul_matches_bigint(spec):
    n = 64
    xs, ys = rand_ints(spec, n), rand_ints(spec, n)
    # include edge cases
    xs[:4] = [0, 1, spec.modulus - 1, spec.modulus - 1]
    ys[:4] = [spec.modulus - 1, spec.modulus - 1, spec.modulus - 1, 1]
    a, b = jnp.asarray(spec.encode(xs)), jnp.asarray(spec.encode(ys))
    out = spec.decode(np.asarray(F.mul(spec, a, b)))
    expect = [(x * y) % spec.modulus for x, y in zip(xs, ys)]
    assert out == expect


@pytest.mark.parametrize("spec", [F.FR, F.FQ], ids=["fr", "fq"])
def test_add_sub_neg(spec):
    n = 32
    xs, ys = rand_ints(spec, n), rand_ints(spec, n)
    xs[0], ys[0] = 0, 0
    xs[1], ys[1] = spec.modulus - 1, spec.modulus - 1
    a, b = jnp.asarray(spec.encode(xs)), jnp.asarray(spec.encode(ys))
    assert spec.decode(np.asarray(F.add(spec, a, b))) == [(x + y) % spec.modulus for x, y in zip(xs, ys)]
    assert spec.decode(np.asarray(F.sub(spec, a, b))) == [(x - y) % spec.modulus for x, y in zip(xs, ys)]
    assert spec.decode(np.asarray(F.neg(spec, a))) == [(-x) % spec.modulus for x in xs]


def test_pow_and_inv():
    spec = F.FR
    xs = rand_ints(spec, 16)
    a = jnp.asarray(spec.encode(xs))
    e = 12345
    assert spec.decode(np.asarray(F.pow_const(spec, a, e))) == [pow(x, e, spec.modulus) for x in xs]
    invs = spec.decode(np.asarray(F.inv(spec, a)))
    assert invs == [pow(x, -1, spec.modulus) for x in xs]


def test_batch_inv_with_zeros():
    spec = F.FR
    xs = rand_ints(spec, 33)
    xs[5] = 0
    xs[17] = 0
    a = jnp.asarray(spec.encode(xs))
    out = spec.decode(np.asarray(F.batch_inv(spec, a)))
    expect = [pow(x, -1, spec.modulus) if x else 0 for x in xs]
    assert out == expect


def test_byte_embedding():
    spec = F.FR
    b = jnp.arange(256, dtype=jnp.uint8)
    out = spec.decode(np.asarray(F.bytes_to_field(spec, b)))
    assert out == list(range(256))


def test_u16_embedding():
    spec = F.FR
    v = jnp.asarray(np.array([0, 1, 255, 65535, 12345], dtype=np.uint32))
    out = spec.decode(np.asarray(F.u16_to_field(spec, v)))
    assert out == [0, 1, 255, 65535, 12345]


def test_root_of_unity():
    w = F.FR.root_of_unity()
    p = F.FR.modulus
    assert pow(w, 1 << 28, p) == 1
    assert pow(w, 1 << 27, p) != 1


@pytest.mark.parametrize("m,out_limbs", [(17, 17), (33, 16), (5, 3)])
def test_carry_norm_matches_bigint(m, out_limbs):
    """The loop-free carry resolves arbitrary 32-bit redundant limbs,
    long 0xFFFF ripples included, to the digits of the value mod 2^(16m)."""
    rng = np.random.default_rng(m)
    acc = rng.integers(0, 1 << 32, (64, m), dtype=np.uint64).astype(np.uint32)
    acc[::2] = np.where(rng.random((32, m)) < 0.7, 0xFFFF, acc[::2])
    acc[1, :] = 0xFFFF
    acc[1, 0] = 0x10000
    got = np.asarray(F._carry_norm(jnp.asarray(acc), out_limbs))
    for row, out in zip(acc, got):
        v = sum(int(x) << (16 * i) for i, x in enumerate(row)) % (1 << (16 * m))
        assert [int(x) for x in out] == [(v >> (16 * i)) & 0xFFFF
                                         for i in range(out_limbs)]

"""NTT correctness vs python-bigint DFT, roundtrips, coset evals."""

import random

import jax.numpy as jnp
import numpy as np

from halo2_aes_tpu.ops import field as F
from halo2_aes_tpu.ops import ntt

SPEC = F.FR
P = SPEC.modulus
RNG = random.Random(99)


def _host_eval(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def test_ntt_matches_naive_dft():
    k = 4
    dom = ntt.domain(SPEC, k)
    coeffs = [RNG.randrange(P) for _ in range(dom.n)]
    evals = SPEC.decode(np.asarray(ntt.ntt(dom, jnp.asarray(SPEC.encode(coeffs)))))
    for i in range(dom.n):
        assert evals[i] == _host_eval(coeffs, pow(dom.omega, i, P)), i


def test_ntt_roundtrip():
    k = 10
    dom = ntt.domain(SPEC, k)
    coeffs = jnp.asarray(SPEC.encode([RNG.randrange(P) for _ in range(dom.n)]))
    back = ntt.ntt(dom, ntt.ntt(dom, coeffs), inverse=True)
    assert SPEC.decode(np.asarray(back)) == SPEC.decode(np.asarray(coeffs))


def test_coset_ntt():
    k = 5
    dom = ntt.domain(SPEC, k)
    g = SPEC.generator
    coeffs_int = [RNG.randrange(P) for _ in range(dom.n)]
    coeffs = jnp.asarray(SPEC.encode(coeffs_int))
    shift = F.powers(SPEC, jnp.asarray(SPEC.encode(g)), dom.n)
    evals = SPEC.decode(np.asarray(ntt.coset_ntt(dom, coeffs, shift)))
    for i in [0, 1, 7, dom.n - 1]:
        x = (g * pow(dom.omega, i, P)) % P
        assert evals[i] == _host_eval(coeffs_int, x)
    # inverse
    shift_inv = F.powers(SPEC, jnp.asarray(SPEC.encode(pow(g, -1, P))), dom.n)
    back = ntt.coset_intt(dom, ntt.coset_ntt(dom, coeffs, shift), shift_inv)
    assert SPEC.decode(np.asarray(back)) == coeffs_int


def test_eval_poly():
    coeffs_int = [RNG.randrange(P) for _ in range(33)]
    x_int = RNG.randrange(P)
    out = ntt.eval_poly(
        SPEC, jnp.asarray(SPEC.encode(coeffs_int)), jnp.asarray(SPEC.encode(x_int))
    )
    assert SPEC.decode(np.asarray(out[None]))[0] == _host_eval(coeffs_int, x_int)


def test_powers_and_dot():
    base_int = RNG.randrange(P)
    pw = F.powers(SPEC, jnp.asarray(SPEC.encode(base_int)), 20)
    assert SPEC.decode(np.asarray(pw)) == [pow(base_int, i, P) for i in range(20)]
    a = [RNG.randrange(P) for _ in range(20)]
    d = F.dot(SPEC, jnp.asarray(SPEC.encode(a)), pw)
    assert SPEC.decode(np.asarray(d[None]))[0] == sum(
        ai * pow(base_int, i, P) for i, ai in enumerate(a)
    ) % P

def test_ntt_flat_matches_per_poly():
    k = 6
    dom = ntt.domain(SPEC, k)
    count = 3
    polys = [[RNG.randrange(P) for _ in range(dom.n)] for _ in range(count)]
    flat = jnp.asarray(SPEC.encode([c for p in polys for c in p]))
    out = ntt.ntt_flat(dom, flat, count)
    for i, p in enumerate(polys):
        one = ntt.ntt(dom, jnp.asarray(SPEC.encode(p)))
        assert (SPEC.decode(np.asarray(out[i * dom.n : (i + 1) * dom.n]))
                == SPEC.decode(np.asarray(one))), i
    back = ntt.ntt_flat(dom, out, count, inverse=True)
    assert SPEC.decode(np.asarray(back)) == SPEC.decode(np.asarray(flat))

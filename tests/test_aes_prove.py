"""Full AES-128 circuit prove -> verify at k=17 (the real circuit: 10
lookups at n_sets=2... here n_sets=1 -> 5 lookups, 66,561-row mega-table,
chunked permutation, exposed-ciphertext instance column), plus negative
tests at that scale.  SURVEY.md section 4 gap closure: the reference
never proves nor verifies its own circuit.

Heavy: AUTO-ENABLED whenever the suite runs on an accelerator
(HALO2_TEST_ON_CARD=1, tests/conftest.py); on the CPU it needs the
HALO2_AES_SLOW=1 opt-in (hours)."""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module", autouse=True)
def _aes_scale_gate():
    if os.environ.get("HALO2_AES_SLOW") == "1":
        return
    import jax

    if jax.default_backend() == "cpu":
        pytest.skip("AES-scale prove: runs on accelerators automatically; "
                    "set HALO2_AES_SLOW=1 to force on CPU (hours)")


def test_aes_prove_verify_and_negatives(tmp_path):
    import jax
    import jax.numpy as jnp

    from halo2_aes_tpu.backend import srs as SRS
    from halo2_aes_tpu.backend.keygen import keygen_cached
    from halo2_aes_tpu.backend.prover import prove
    from halo2_aes_tpu.backend.verifier import VerifyError, verify
    from halo2_aes_tpu.circuit import witness
    from halo2_aes_tpu.models.aes128 import AesConfig, compile_circuit
    from halo2_aes_tpu.ops import aes

    cfg = AesConfig(k=17, n_sets=1, n_blocks=2, expose_ciphertext=True)
    layout = compile_circuit(cfg)
    srs = SRS.setup(17)
    pk = keygen_cached(layout, srs)

    rng = np.random.default_rng(7)
    key = rng.integers(0, 256, 16, dtype=np.uint8)
    pts = rng.integers(0, 256, (2, 16), dtype=np.uint8)
    pool = witness.build_pool(jnp.asarray(key), jnp.asarray(pts))
    values = jax.block_until_ready(witness.assemble_values(layout, pool))

    ct = [int(v) for v in np.asarray(aes.encrypt(pts, key)).reshape(-1)]
    proof = prove(pk, values, instances=[ct])
    assert verify(pk.vk, proof, instances=[ct])

    # the proof binds the TRUE ciphertext: a flipped public input fails
    bad_ct = list(ct)
    bad_ct[0] ^= 1
    with pytest.raises(VerifyError):
        verify(pk.vk, proof, instances=[bad_ct])

    # corrupt one witness byte -> the (re)proof fails verification
    bad = np.asarray(values).copy()
    adv = layout.advice_ids()[0]
    row = int(np.nonzero(layout.witness_map[adv] >= 0)[0][10])
    bad[adv, row] ^= 1
    bad_proof = prove(pk, jnp.asarray(bad), instances=[ct])
    with pytest.raises(VerifyError):
        verify(pk.vk, bad_proof, instances=[ct])

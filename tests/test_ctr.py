"""AES-128-CTR layer: counter-block layout, NIST vectors, proof bundles.

Fast tier: counter construction + keystream XOR validated against the
official SP 800-38A F.5.1 CTR-AES128 vectors (the reference has no
mode-of-operation layer at all).  The end-to-end bundle prove/verify is
auto-enabled on accelerators like the other AES-scale proves
(HALO2_AES_SLOW=1 forces it on CPU)."""

import os

import numpy as np
import pytest

from halo2_aes_tpu import ctr


@pytest.fixture(autouse=True)
def _aes_scale_gate(request):
    if "slow" not in request.keywords:
        return
    if os.environ.get("HALO2_AES_SLOW") == "1":
        return
    import jax

    if jax.default_backend() == "cpu":
        pytest.skip("AES-scale prove: runs on accelerators automatically; "
                    "set HALO2_AES_SLOW=1 to force on CPU (hours)")


def test_counter_block_layout():
    nonce = bytes(range(12))
    blocks = ctr.counter_blocks(nonce, start=0xFFFFFFFE, count=2)
    assert blocks.shape == (2, 16)
    assert bytes(blocks[0, :12]) == nonce
    assert bytes(blocks[0, 12:]) == bytes([0xFF, 0xFF, 0xFF, 0xFE])
    assert bytes(blocks[1, 12:]) == bytes([0xFF, 0xFF, 0xFF, 0xFF])
    with pytest.raises(AssertionError):
        ctr.counter_blocks(nonce, start=0xFFFFFFFF, count=2)  # overflow
    with pytest.raises(AssertionError):
        ctr.counter_blocks(b"short", 0, 1)


def test_nist_sp800_38a_ctr_vectors():
    """SP 800-38A F.5.1 CTR-AES128.Encrypt: init counter block
    f0f1..feff == nonce f0..fb + ctr32 start 0xfcfdfeff (the low word
    never carries into the nonce across these 4 blocks)."""
    from halo2_aes_tpu.ops import aes

    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    nonce = bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafb")
    pt = bytes.fromhex(
        "6bc1bee22e409f96e93d7e117393172a"
        "ae2d8a571e03ac9c9eb76fac45af8e51"
        "30c81c46a35ce411e5fbc1191a0a52ef"
        "f69f2445df4f9b17ad2b417be66c3710")
    expect = bytes.fromhex(
        "874d6191b620e3261bef6864990db6ce"
        "9806f66b7970fdff8617187bb9fffdff"
        "5ae4df3edbd5d35e5b4f09020db03eab"
        "1e031dda2fbe03d1792170a0f3009cee")

    ctrs = ctr.counter_blocks(nonce, start=0xFCFDFEFF, count=4)
    ks = np.asarray(aes.encrypt(ctrs, np.frombuffer(key, np.uint8)))
    bundle = ctr.CtrBundle(nonce=nonce, start=0xFCFDFEFF, n_blocks=4,
                           blocks_per_proof=4, keystream=ks)
    assert ctr.xor_keystream(bundle, pt) == expect
    # CTR decrypt == encrypt
    assert ctr.xor_keystream(bundle, expect) == pt


def test_bundle_instances_split():
    ks = np.arange(4 * 16, dtype=np.uint8).reshape(4, 16)
    b = ctr.CtrBundle(nonce=bytes(12), start=0, n_blocks=3,
                      blocks_per_proof=2, keystream=ks)
    inst = b.instances()
    assert len(inst) == 2 and len(inst[0]) == 32
    assert inst[1][0] == 32  # second proof starts at byte 32


@pytest.mark.slow
def test_ctr_bundle_prove_verify():
    """3 keystream blocks at blocks_per_proof=2 -> 2 proofs (padded
    final chunk), ONE pairing-product verification for the bundle, and
    a tampered public keystream byte fails."""
    from halo2_aes_tpu.backend import srs as SRS
    from halo2_aes_tpu.backend.keygen import keygen_cached
    from halo2_aes_tpu.backend.verifier import VerifyError
    from halo2_aes_tpu.models.aes128 import AesConfig, compile_circuit
    from halo2_aes_tpu.ops import aes

    layout = compile_circuit(
        AesConfig(k=17, n_sets=1, n_blocks=2, expose_ciphertext=True))
    pk = keygen_cached(layout, SRS.setup(17))

    key = np.frombuffer(
        bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c"), np.uint8)
    nonce = bytes(range(12))
    bundle = ctr.prove_keystream(pk, key, nonce, n_blocks=3)
    assert len(bundle.proofs) == 2
    assert bundle.keystream.shape == (4, 16)
    # keystream matches the independent oracle
    np.testing.assert_array_equal(
        bundle.keystream,
        np.asarray(aes.encrypt(ctr.counter_blocks(nonce, 0, 4), key)))
    assert ctr.verify_bundle(pk.vk, bundle)
    # data round trip through the proven keystream
    msg = b"attack at dawn! " * 3
    assert ctr.xor_keystream(bundle, ctr.xor_keystream(bundle, msg)) == msg
    # tampering with the public keystream breaks the instance binding
    bundle.keystream[0, 0] ^= 1
    with pytest.raises(VerifyError):
        ctr.verify_bundle(pk.vk, bundle)

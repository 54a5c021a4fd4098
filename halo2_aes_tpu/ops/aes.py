"""Batched AES-128 witness engine.

This is the batched replacement for the reference's cell-by-cell witness
assignment (reference src/aes128.rs:154-265, src/key_schedule.rs:80-224,
src/utils.rs:8-33): instead of assigning one region per byte op through a
dynamic Layouter, we compute the *entire trace* of every AES block as a
flat "value pool" with pure, vmappable jnp ops.  The circuit layer then
scatters pool values into advice columns with precomputed index maps.

Pool layouts (all uint8):

Key-schedule pool, length 336 = 16 + 10 * 32:
  [0:16]                      key bytes (round key 0)
  per round r in 1..10 at base=16+(r-1)*32:
    [base+ 0: base+ 4]        shifted   = prev[13,14,15,12]   (RotWord)
    [base+ 4: base+ 8]        subbed    = SBOX[shifted]       (SubWord)
    [base+ 8: base+12]        rc word   = [RCON[r-1], 0, 0, 0]
    [base+12: base+16]        rconned   = subbed ^ rc word
    [base+16: base+32]        w         = 16 new round-key bytes

Block pool, length 1360 == AES_BLOCK_ROWS (one value per circuit row):
  [0:16]      plaintext
  [16:32]     initial AddRoundKey
  rounds r in 1..9 at base=32+(r-1)*144:
    [base   : base+ 16]  SubBytes outputs
    [base+16: base+128]  MixColumns: for output (word i, row m), 7 values
                         [tmp0..tmp3, inter1, inter2, out] at
                         base+16+(4i+m)*7+k   (ShiftRows itself is free:
                         pure index rewiring, zero rows, matching
                         reference src/aes128.rs:211-223)
    [base+128: base+144] AddRoundKey
  round 10 at 1328: [1328:1344] SubBytes, [1344:1360] AddRoundKey
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from halo2_aes_tpu.models import constants as C

KS_POOL_LEN = 16 + 10 * 32
BLOCK_POOL_LEN = C.AES_BLOCK_ROWS


def _take(table_np: np.ndarray, idx):
    return jnp.take(jnp.asarray(table_np), idx.astype(jnp.int32))


def expand_key(key):
    """AES-128 key expansion trace.

    key: uint8[16] -> (ks_pool uint8[336], round_keys uint8[11, 16])
    """
    key = key.astype(jnp.uint8)
    rot_idx = jnp.asarray(np.array([13, 14, 15, 12], dtype=np.int32))
    pool = [key]
    rks = [key]
    prev = key
    for r in range(1, 11):
        shifted = prev[rot_idx]
        subbed = _take(C.S_BOX, shifted)
        rc_word = jnp.concatenate(
            [jnp.asarray(C.ROUND_CONSTANTS[r - 1 : r]), np.zeros(3, np.uint8)]
        )
        rconned = subbed ^ rc_word
        w0 = prev[0:4] ^ rconned
        w1 = prev[4:8] ^ w0
        w2 = prev[8:12] ^ w1
        w3 = prev[12:16] ^ w2
        w = jnp.concatenate([w0, w1, w2, w3])
        pool += [shifted, subbed, rc_word, rconned, w]
        rks.append(w)
        prev = w
    return jnp.concatenate(pool), jnp.stack(rks)


def block_pool(plaintext, round_keys):
    """Full circuit trace of one AES-128 encryption.

    plaintext: uint8[16], round_keys: uint8[11,16] -> uint8[1360].
    vmap over the leading axis of plaintext for batching.
    """
    pt = plaintext.astype(jnp.uint8)
    shift_idx = jnp.asarray(C.SHIFT_ROWS_IDX)
    coeff = jnp.asarray(C.MIX_MATRIX)[None, :, :]  # (1, m, j)

    parts = [pt]
    state = pt ^ round_keys[0]
    parts.append(state)
    for r in range(1, 11):
        sub = _take(C.S_BOX, state)
        parts.append(sub)
        shifted = sub[shift_idx]
        if r < 10:
            s = shifted.reshape(4, 4)[:, None, :]  # (i, 1, j)
            tmp = jnp.where(
                coeff == 1,
                s,
                jnp.where(coeff == 2, _take(C.MUL_BY_2, s), _take(C.MUL_BY_3, s)),
            )  # (i, m, j)
            inter1 = tmp[..., 0] ^ tmp[..., 1]
            inter2 = tmp[..., 2] ^ tmp[..., 3]
            out = inter1 ^ inter2  # (i, m)
            group = jnp.concatenate(
                [tmp, inter1[..., None], inter2[..., None], out[..., None]], axis=-1
            )  # (i, m, 7)
            parts.append(group.reshape(112))
            mixed = out.reshape(16)
        else:
            mixed = shifted
        state = mixed ^ round_keys[r]
        parts.append(state)
    return jnp.concatenate(parts)


block_pool_batch = jax.vmap(block_pool, in_axes=(0, None))


def dec_block_pool(ciphertext, round_keys):
    """Full circuit trace of one AES-128 decryption (straightforward
    inverse cipher, FIPS-197 §5.3).  NOT in the reference — it stages the
    InvMixColumns tables but implements no decryption (reference
    src/constant.rs:49-111).

    ciphertext: uint8[16], round_keys: uint8[11,16] -> uint8[1360]:
      [0:16]     ciphertext
      [16:32]    initial AddRoundKey (rk10)
      rounds rr in 1..9 (round key 10-rr) at base=32+(rr-1)*144:
        [base   : base+16]   InvSubBytes outputs (InvShiftRows is free
                             index rewiring, mirroring encryption)
        [base+16: base+32]   AddRoundKey outputs
        [base+32: base+144]  InvMixColumns lcon: for output (word i,
                             row m), 7 values [tmp0..3, inter1, inter2,
                             out] at base+32+(4i+m)*7+t
      [1328:1344] final InvSubBytes, [1344:1360] AddRoundKey (rk0)
                  = recovered plaintext
    """
    ct = ciphertext.astype(jnp.uint8)
    inv_shift = jnp.asarray(C.INV_SHIFT_ROWS_IDX)
    coeff = jnp.asarray(C.INV_MIX_MATRIX)[None, :, :]  # (1, m, j)

    parts = [ct]
    state = ct ^ round_keys[10]
    parts.append(state)
    for rr in range(1, 11):
        sub = _take(C.INV_S_BOX, state[inv_shift])
        parts.append(sub)
        ark = sub ^ round_keys[10 - rr]
        parts.append(ark)
        if rr == 10:
            break
        s = ark.reshape(4, 4)[:, None, :]  # (i, 1, j)
        tmp = jnp.where(
            coeff == 9,
            _take(C.MUL_BY_9, s),
            jnp.where(
                coeff == 11,
                _take(C.MUL_BY_11, s),
                jnp.where(coeff == 13, _take(C.MUL_BY_13, s),
                          _take(C.MUL_BY_14, s)),
            ),
        )  # (i, m, j)
        inter1 = tmp[..., 0] ^ tmp[..., 1]
        inter2 = tmp[..., 2] ^ tmp[..., 3]
        out = inter1 ^ inter2  # (i, m)
        group = jnp.concatenate(
            [tmp, inter1[..., None], inter2[..., None], out[..., None]], axis=-1
        )  # (i, m, 7)
        parts.append(group.reshape(112))
        state = out.reshape(16)
    return jnp.concatenate(parts)


dec_block_pool_batch = jax.vmap(dec_block_pool, in_axes=(0, None))


def decrypt(ciphertext, key):
    """Plain AES-128 ECB decrypt of one or many 16-byte blocks (oracle)."""
    _, rks = expand_key(jnp.asarray(key, dtype=jnp.uint8))
    ct = jnp.asarray(ciphertext, dtype=jnp.uint8)
    if ct.ndim == 1:
        return dec_block_pool(ct, rks)[-16:]
    return dec_block_pool_batch(ct, rks)[:, -16:]


def encrypt(plaintext, key):
    """Plain AES-128 ECB encrypt of one or many 16-byte blocks (oracle)."""
    _, rks = expand_key(jnp.asarray(key, dtype=jnp.uint8))
    pt = jnp.asarray(plaintext, dtype=jnp.uint8)
    if pt.ndim == 1:
        return block_pool(pt, rks)[-16:]
    return block_pool_batch(pt, rks)[:, -16:]


def ctr_blocks(nonce: int, count: int) -> np.ndarray:
    """uint8[count,16] big-endian counter blocks for AES-CTR batching."""
    out = np.zeros((count, 16), dtype=np.uint8)
    for i in range(count):
        v = (nonce << 64) | i
        out[i] = np.frombuffer(v.to_bytes(16, "big"), dtype=np.uint8)
    return out

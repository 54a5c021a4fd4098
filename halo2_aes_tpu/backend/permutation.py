"""Permutation (copy-constraint) argument: keygen cycles + grand products.

Role of halo2's permutation::keygen Assembly and permutation prover
(SURVEY.md section 2.13 items 2-3).  Keygen turns the layout's explicit
copy-pair list into cycle permutations sigma (host, union-find); the
prover builds the chunked grand-product columns z_t on device with one
batched inversion and an associative-scan cumulative product — replacing
halo2's sequential row loop.

Identity labels: cell (perm column i, row j) gets delta^i * omega^j,
with delta = g^(2^s) (generator of the odd-order subgroup), so labels
are globally unique.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from halo2_aes_tpu.ops import field as F
from halo2_aes_tpu.ops.ntt import domain

FR = F.FR


@functools.lru_cache(maxsize=None)
def delta() -> int:
    return pow(7, 1 << FR.two_adicity, FR.modulus)


@functools.lru_cache(maxsize=None)
def _label_tables(k: int, m: int):
    """(omega_pows (n,16), delta_pows (m,16)) Montgomery tables."""
    w = domain(FR, k).omega
    return (jnp.asarray(FR.host_powers(w, 1 << k)),
            jnp.asarray(FR.host_powers(delta(), m)))


@dataclass
class PermutationAssembly:
    """sigma mapping: for perm-column i, row j -> (col', row').

    The sigma/id label *values* (delta^i omega^j Montgomery tensors) are
    built inside keygen's single jitted executable (keygen._keygen_jit)
    from these maps plus the _label_tables host tables."""

    perm_columns: list          # global column ids, order = delta exponent
    map_col: np.ndarray         # (m, n) int32
    map_row: np.ndarray         # (m, n) int32


def build_assembly(perm_columns, n: int, copy_pairs: np.ndarray) -> PermutationAssembly:
    """Union copy pairs into cycles; sigma = one cyclic rotation per class.

    copy_pairs: (P, 4) int32 (col_a, row_a, col_b, row_b) global ids;
    every referenced column must be equality-enabled.

    Fully vectorized: connected components via min-label propagation with
    pointer doubling (O(log diameter) sweeps over numpy arrays — the
    per-pair Python union-find this replaces dominated keygen), then one
    argsort to link every equivalence class into a cycle.
    """
    m = len(perm_columns)
    N = m * n
    if N == 0:
        # no equality-enabled columns: empty permutation argument
        z = np.zeros((0, n), dtype=np.int32)
        return PermutationAssembly(list(perm_columns), z, z)
    pairs = np.asarray(copy_pairs, dtype=np.int64).reshape(-1, 4)
    parent = np.arange(N, dtype=np.int64)

    if len(pairs):
        pos_lut = np.full(int(max(perm_columns)) + 1, -1, dtype=np.int64)
        for i, c in enumerate(perm_columns):
            pos_lut[c] = i
        ca, ra, cb, rb = pairs.T
        pa_, pb_ = pos_lut[ca], pos_lut[cb]
        assert (pa_ >= 0).all() and (pb_ >= 0).all(), (
            "copy pair references a column without equality enabled")
        a = pa_ * n + ra
        b = pb_ * n + rb

        while True:
            # hook: point the larger label at the smaller (dup-safe)
            la, lb = parent[a], parent[b]
            lo, hi = np.minimum(la, lb), np.maximum(la, lb)
            np.minimum.at(parent, hi, lo)
            # compress: pointer doubling to fixpoint
            while True:
                nxt = parent[parent]
                if np.array_equal(nxt, parent):
                    break
                parent = nxt
            if np.array_equal(parent[a], parent[b]):
                break

    roots = parent
    # next-in-cycle: stable-sort members by root, link each run circularly
    order = np.argsort(roots, kind="stable")
    sr = roots[order]
    is_start = np.empty(N, dtype=bool)
    is_start[0] = True
    np.not_equal(sr[1:], sr[:-1], out=is_start[1:])
    starts = np.flatnonzero(is_start)
    nxt_pos = np.arange(1, N + 1, dtype=np.int64)
    run_ends = np.concatenate([starts[1:] - 1, [N - 1]])
    nxt_pos[run_ends] = starts
    nxt = np.empty(N, dtype=np.int64)
    nxt[order] = order[nxt_pos]
    return PermutationAssembly(
        list(perm_columns),
        (nxt // n).astype(np.int32).reshape(m, n),
        (nxt % n).astype(np.int32).reshape(m, n),
    )


def grand_products(k: int, usable: int, chunk_len: int, all_fld,
                   perm_columns, map_col, map_row, omega_pows, delta_pows,
                   beta_m, gamma_m, blinding):
    """Build the chunked permutation grand-product columns, STREAMED
    one perm column at a time.

    all_fld: FLAT (cols*n, LIMBS) Montgomery evaluation-form columns
    (the prover's resident column tensor); perm_columns: global ids of
    the equality-enabled columns in delta-exponent order.  The sigma/id
    label values for column i are rebuilt here from the int32 maps +
    the omega/delta power tables, ONE column at a time: materializing
    the full (m*n, LIMBS) num/den/ratio/sigma/id tensors at once (the
    pre-r3 shape of this function) peaked >3.5 GB of transient device
    memory at k=20.  Per-column streaming peaks ~7 column-sized
    buffers; one batched inversion per CHUNK (not per column).

    beta_m/gamma_m: (16,) Montgomery challenges.  blinding: (chunks,
    blind_rows, LIMBS) random tails.  Returns FLAT (chunks*n, LIMBS);
    z_t[0] = z_{t-1}[usable] (chunk linking), z_0[0] = 1.  All device
    tensors stay rank-2 (rows, 16)."""
    n = 1 << k
    m = len(perm_columns)
    chunks = -(-m // chunk_len)

    one = jnp.asarray(FR.one_mont)
    active = jnp.arange(n) < usable
    zs = []
    init = one
    for t in range(chunks):
        cols = range(t * chunk_len, min((t + 1) * chunk_len, m))
        num_r = den_r = None
        for i in cols:
            v = all_fld[perm_columns[i] * n : (perm_columns[i] + 1) * n]
            sig = F.mont_mul(FR,
                             jnp.take(delta_pows, map_col[i], axis=0),
                             jnp.take(omega_pows, map_row[i], axis=0))
            idv = F.mont_mul(FR, delta_pows[i], omega_pows)
            num_i = F.add(FR, v, F.add(FR, F.mont_mul(FR, beta_m, idv),
                                       gamma_m))
            den_i = F.add(FR, v, F.add(FR, F.mont_mul(FR, beta_m, sig),
                                       gamma_m))
            num_r = num_i if num_r is None else F.mont_mul(FR, num_r, num_i)
            den_r = den_i if den_r is None else F.mont_mul(FR, den_r, den_i)
        row_ratio = F.mont_mul(FR, num_r, F.batch_inv(FR, den_r))
        row_ratio = F.select(active, row_ratio,
                             jnp.broadcast_to(one, row_ratio.shape))
        # inclusive scan then shift: z[j] = init * prod_{l<j} ratio[l]
        cum = F.cumprod(FR, row_ratio)
        z = jnp.concatenate([jnp.broadcast_to(one, (1, F.LIMBS)), cum[:-1]], axis=0)
        z = F.mont_mul(FR, z, init)
        init = F.mont_mul(FR, init, cum[usable - 1])  # z_t[usable]
        z = jnp.concatenate([z[: n - blinding.shape[1]], blinding[t]], axis=0)
        zs.append(z)
    return jnp.concatenate(zs)

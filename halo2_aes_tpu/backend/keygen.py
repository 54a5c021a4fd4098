"""Key generation: verifying key + proving key from a compiled circuit.

Role of halo2's keygen_vk/keygen_pk (reference src/main.rs:78-79).  The
reference synthesizes the circuit twice more here; our layout is static,
so keygen is: lift fixed columns to field form, build the permutation
assembly from the precompiled copy-pair list, NTT everything once, and
commit (device MSMs).
"""

from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from halo2_aes_tpu.backend import permutation as PERM
from halo2_aes_tpu.backend import protocol as PROTO
from halo2_aes_tpu.backend.srs import SRS
from halo2_aes_tpu.circuit.ir import CompiledCircuit
from halo2_aes_tpu.ops import curve as CV
from halo2_aes_tpu.ops import field as F
from halo2_aes_tpu.ops.ntt import domain, ntt_many

FR = F.FR


@dataclass
class VerifyingKey:
    k: int
    ext_k: int
    usable: int
    cs: object                       # host ConstraintSystem
    fixed_ids: list                  # global ids, commitment order
    fixed_commitments: list          # affine (x, y) plain-int pairs
    sigma_commitments: list
    g2: tuple = None                 # G2 generator (affine Fq2)
    s_g2: tuple = None               # [tau] G2
    digest: int = 0

    def _compute_digest(self) -> int:
        """Byte-serialized vk digest (role of halo2's pinned-vk hash).

        Everything is fixed-width binary via ir.cs_bytes — no ``repr``
        (Python repr stability is not a protocol)."""
        from halo2_aes_tpu.backend.transcript import point_to_bytes
        from halo2_aes_tpu.circuit.ir import cs_bytes

        h = hashlib.blake2b(b"halo2_aes_tpu vk v2", digest_size=64)
        for v in (self.k, self.ext_k, self.usable):
            h.update(int(v).to_bytes(8, "little"))
        h.update(cs_bytes(self.cs))
        for pt in self.fixed_commitments + self.sigma_commitments:
            h.update(point_to_bytes(pt))
        return int.from_bytes(h.digest(), "little") % FR.modulus


@dataclass
class ProvingKey:
    vk: VerifyingKey
    srs: SRS
    layout: CompiledCircuit
    assembly: object                 # PermutationAssembly (cached to disk)
    fixed_coeffs: dict               # col id -> (n, 16) coefficients
    sigma_coeffs: jnp.ndarray        # FLAT (m*n, 16)
    perm_maps: tuple                 # (map_col, map_row) int32 device arrays;
    #   the prover rebuilds sigma/id label VALUES in-graph per proof —
    #   keeping the two (m*n, 16) value tensors resident costs ~1.2 GB
    #   of device memory at k=20
    l0_coeffs: jnp.ndarray
    l_last_coeffs: jnp.ndarray
    l_active_coeffs: jnp.ndarray


def _commit_affine(srs: SRS, coeffs):
    if srs.n <= 512:
        # toy circuits (tests, multichip dryrun): host bigint MSM beats
        # the device path's one-time XLA compile by ~a minute on the
        # single-CPU host
        g1 = _srs_host_points(srs)
        scalars = FR.decode(coeffs)
        return CV.host_msm(g1[: len(scalars)], scalars)
    return CV.to_affine_host(srs.commit(coeffs))[0]


def _srs_host_points(srs: SRS) -> list:
    pts = getattr(srs, "_host_points", None)
    if pts is None:
        from halo2_aes_tpu.ops.field import FQ

        xs = np.asarray(srs.g1_x)
        ys = np.asarray(srs.g1_y)
        pts = [(FQ.from_mont_host(F.limbs_to_int(xs[i])),
                FQ.from_mont_host(F.limbs_to_int(ys[i])))
               for i in range(xs.shape[0])]
        object.__setattr__(srs, "_host_points", pts)
    return pts


def layout_fingerprint(layout: CompiledCircuit) -> str:
    """Stable hash of everything keygen consumes from the layout."""
    import numpy as _np

    from halo2_aes_tpu.circuit.ir import cs_bytes

    h = hashlib.blake2b(digest_size=16)
    h.update(layout.k.to_bytes(4, "little"))
    h.update(cs_bytes(layout.cs))
    h.update(_np.ascontiguousarray(layout.fixed).tobytes())
    h.update(_np.ascontiguousarray(layout.copy_pairs).tobytes())
    return h.hexdigest()


def srs_identity(srs: SRS) -> str:
    """Short identity tag of a concrete SRS instance.

    Hashes a few G1 powers plus the G2 side, so a re-generated SRS with
    a different tau (or a ceremony SRS of the same k) never aliases a
    cached proving key built for another tau — stale fixed/sigma
    commitments would make every honest proof fail the pairing check."""
    return srs.identity_tag()


def keygen_cached(layout: CompiledCircuit, srs: SRS,
                  cache_dir: str = "ptau") -> ProvingKey:
    """keygen with an on-disk cache of the expensive artifacts: fixed and
    sigma commitments AND the permutation assembly maps (role of the
    reference's SRS cache, src/main.rs:70-75, extended to the proving key
    per SURVEY.md section 5.4).  Cache key = layout fingerprint + SRS k
    + SRS identity (see srs_identity)."""
    import os

    tag = layout_fingerprint(layout)
    srs.warm_tables()   # build MSM tables before keygen fills memory
    path = os.path.join(cache_dir, f"pk_{tag}_s{srs.k}_{srs_identity(srs)}.npz")
    def _dump(pts):
        # identity commitments (all-zero columns) serialize as ("", "")
        return np.array([["", ""] if pt is None else [str(pt[0]), str(pt[1])]
                         for pt in pts], dtype=object)

    def _load(arr):
        return [None if pt[0] == "" else tuple(int(v) for v in pt)
                for pt in arr]

    if os.path.exists(path):
        z = np.load(path, allow_pickle=True)
        pk = keygen(layout, srs, _precomputed={
            "fixed_comms": _load(z["fixed_comms"]),
            "sigma_comms": _load(z["sigma_comms"]),
            "assembly": PERM.PermutationAssembly(
                list(layout.cs.perm_columns), z["map_col"], z["map_row"]),
        })
        return pk
    pk = keygen(layout, srs)
    os.makedirs(cache_dir, exist_ok=True)
    np.savez(
        path,
        fixed_comms=_dump(pk.vk.fixed_commitments),
        sigma_comms=_dump(pk.vk.sigma_commitments),
        map_col=pk.assembly.map_col,
        map_row=pk.assembly.map_row,
    )
    return pk


@functools.lru_cache(maxsize=None)
def _keygen_jit(k: int, cf: int, m_perm: int, usable: int):
    """ONE jitted executable for all of keygen's device math: fixed-column
    field lift + INTT, sigma/id label tables, sigma INTTs, and the three
    indicator-poly INTTs.  Keygen previously dispatched each of these
    eagerly per column — tens of seconds of per-op dispatch/compile."""
    import jax

    dom = domain(FR, k)
    n = dom.n

    def run(fixed_stack, map_col, map_row, omega_pows, delta_pows):
        fld = F.u16_to_field(FR, fixed_stack.reshape(-1))     # (cf*n, 16)
        fixed_coeffs = ntt_many(dom, fld, cf, inverse=True)

        if m_perm:
            sigma_values = F.mont_mul(
                FR,
                jnp.take(delta_pows, map_col.reshape(-1), axis=0),
                jnp.take(omega_pows, map_row.reshape(-1), axis=0))
            sigma_coeffs = ntt_many(dom, sigma_values, m_perm, inverse=True)
        else:
            z = jnp.zeros((0, F.LIMBS), jnp.uint32)
            sigma_coeffs = z

        rows = jnp.arange(n)
        one = jnp.broadcast_to(jnp.asarray(FR.one_mont), (n, F.LIMBS))
        zero = jnp.zeros((n, F.LIMBS), jnp.uint32)
        ind = jnp.concatenate([
            F.select(rows == 0, one, zero),
            F.select(rows == usable, one, zero),
            F.select(rows < usable, one, zero),
        ])
        ind_coeffs = ntt_many(dom, ind, 3, inverse=True)
        return (fixed_coeffs, sigma_coeffs, ind_coeffs)

    return jax.jit(run)


def keygen(layout: CompiledCircuit, srs: SRS,
           _precomputed: dict | None = None) -> ProvingKey:
    cs = layout.cs
    k = layout.k
    assert srs.k >= k, "SRS too small"
    n = layout.n
    ext_k = k + max(1, (cs.degree() - 2).bit_length())  # ext_n >= (d-1) n
    usable = layout.usable_rows

    # Only fixed columns the protocol references (gates/lookups/
    # permutation) are lifted and committed: unreferenced ones (pruned
    # dead selectors) are all-zero and would commit to the identity
    # point, which halo2 transcripts reject (reference src/main.rs:92).
    referenced = cs.referenced_columns()
    fixed_ids = [c for c in layout.fixed_ids() if c in referenced]
    fixed_stack = layout.fixed[fixed_ids]                 # (cf, n) numpy
    assert int(fixed_stack.max(initial=0)) < (1 << 16)

    if _precomputed is not None and "assembly" in _precomputed:
        assembly = _precomputed["assembly"]
    else:
        assembly = PERM.build_assembly(cs.perm_columns, n, layout.copy_pairs)
    m_perm = len(cs.perm_columns)
    omega_pows, delta_pows = PERM._label_tables(k, max(m_perm, 1))

    run = _keygen_jit(k, len(fixed_ids), m_perm, usable)
    map_col = jnp.asarray(assembly.map_col, dtype=jnp.int32)
    map_row = jnp.asarray(assembly.map_row, dtype=jnp.int32)
    (fixed_coeffs_flat, sigma_coeffs, ind_coeffs) = run(
        jnp.asarray(fixed_stack), map_col, map_row, omega_pows, delta_pows)

    # NOTE: the Lagrange-basis fixed values (fld_flat) are NOT kept on
    # the pk: no consumer needs them post-keygen and the dict held
    # ~1.6 GB of dead device memory at k=20.
    fixed_coeffs = {c: fixed_coeffs_flat[i * n : (i + 1) * n]
                    for i, c in enumerate(fixed_ids)}
    if _precomputed is None:
        fixed_comms = [_commit_affine(srs, fixed_coeffs[c])
                       for c in fixed_ids]
        sigma_comms = [_commit_affine(srs, sigma_coeffs[i * n : (i + 1) * n])
                       for i in range(m_perm)]
    else:
        fixed_comms = _precomputed["fixed_comms"]
        sigma_comms = _precomputed["sigma_comms"]

    l0 = ind_coeffs[:n]
    l_last = ind_coeffs[n : 2 * n]
    l_active = ind_coeffs[2 * n : 3 * n]

    vk = VerifyingKey(k, ext_k, usable, cs, fixed_ids, fixed_comms, sigma_comms,
                      g2=srs.g2, s_g2=srs.s_g2)
    vk.digest = vk._compute_digest()
    return ProvingKey(
        vk=vk,
        srs=srs,
        layout=layout,
        assembly=assembly,
        fixed_coeffs=fixed_coeffs,
        sigma_coeffs=sigma_coeffs,
        perm_maps=(map_col, map_row),
        l0_coeffs=l0,
        l_last_coeffs=l_last,
        l_active_coeffs=l_active,
    )

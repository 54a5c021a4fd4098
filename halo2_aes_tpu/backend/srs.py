"""KZG structured reference string: setup, cache, commit.

Role of halo2's ParamsKZG (reference src/main.rs:61-81: load cached SRS
from ptau/ else generate).  Differences, by design:
  * generation is deterministic from a seed (reference uses OsRng);
    production deployments load a ceremony SRS instead,
  * the tau-power G1 table is computed ON DEVICE: host builds 32x256
    fixed-window tables of G1 multiples (python bigints, ~8k adds),
    the device gathers by scalar digits and tree-adds — generating
    2^k points costs one batched 5-level add tree instead of 2^k host
    scalar muls,
  * cache format is numpy .npz (no Rust interop possible here).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from halo2_aes_tpu.backend import pairing as PR
from halo2_aes_tpu.ops import curve as CV
from halo2_aes_tpu.ops import field as F
from halo2_aes_tpu.ops import msm as MSM

FR, FQ = F.FR, F.FQ

_WINDOW = 8
_NWIN = -(-MSM.SCALAR_BITS // _WINDOW)


@dataclass
class SRS:
    """g1 powers [tau^i]G1 (affine Montgomery limb arrays) + G2 side."""

    k: int
    g1_x: jnp.ndarray        # (n, 16)
    g1_y: jnp.ndarray
    g2: tuple                # G2 generator, affine Fq2 ints
    s_g2: tuple              # [tau] G2
    cache_dir: str | None = None   # where setup() may cache derived tables
    g1_extra: tuple | None = None  # [tau^n] G1 (plain affine ints): one power
    #   past the committable range, used only to stagger-blind the quotient
    #   pieces (backend/prover.py) so no commitment is ever the identity.
    #   None for ceremony .srs files (halo2 format carries exactly n powers);
    #   the prover then skips the piece blinds.
    u_pt: tuple | None = None      # IPA folding point U (plain affine ints);
    #   set only by backend/ipa.py's transparent setup — None for KZG.
    w_pt: tuple | None = None      # IPA blinding point W (plain affine ints):
    #   carries the per-round Pedersen blinds of the opening argument
    #   (halo2 poly/ipa's W); hash-derived in backend/ipa.py, None for KZG.

    @property
    def n(self) -> int:
        return 1 << self.k

    def identity_tag(self) -> str:
        """Short identity of this concrete SRS (hash of a few G1 powers
        + the G2 side) — distinguishes same-k SRS instances with
        different tau (see keygen.srs_identity).  Cached after the first
        call; setup() precomputes it from the host arrays so the tag
        never forces an early device sync."""
        tag = getattr(self, "_tag", None)
        if tag is None:
            tag = _tag_from_host(np.asarray(self.g1_x[:4]),
                                 np.asarray(self.g1_y[:4]), self.s_g2)
            object.__setattr__(self, "_tag", tag)
        return tag

    def evict_tables(self) -> None:
        """Drop the resident MSM window tables (2.75 GiB at k=20).

        The quotient phase's sub-coset NTT storm needs that memory back;
        the next commit reloads the tables lazily from the npz cache
        (seconds of host->device transfer, paid once per eviction)."""
        object.__setattr__(self, "_msm_tables", None)

    def warm_tables(self) -> None:
        """Load-or-build the MSM window tables NOW, while device memory
        is empty.  Building them mid-keygen (first commit) races the
        keygen coefficient arrays for device memory at k=20; called up
        front the build temps have the device to themselves and later
        commits just reuse the resident table."""
        if getattr(self, "_msm_tables", None) is None:
            c = MSM.default_window(self.n)
            object.__setattr__(self, "_msm_tables",
                               self._load_or_build_tables(c))

    def commit(self, coeffs_mont):
        """Commit a coefficient-form poly ((m, 16) Montgomery, m <= n).

        Uses window-shifted point tables (MSM.build_tables, cached on
        this SRS) so the device MSM has no sequential Horner tail; short
        polys are zero-padded (zero scalars land in the skipped bucket
        0, costing nothing but sort keys)."""
        m = coeffs_mont.shape[0]
        scalars = F.from_mont(FR, coeffs_mont)
        if m < self.n:
            scalars = jnp.concatenate(
                [scalars, jnp.zeros((self.n - m, F.LIMBS), jnp.uint32)])
        c = MSM.default_window(self.n)
        tables = getattr(self, "_msm_tables", None)
        if tables is None:
            tables = self._load_or_build_tables(c)
            object.__setattr__(self, "_msm_tables", tables)
        return MSM.msm((self.g1_x, self.g1_y), scalars, c=c, tables=tables)

    def _load_or_build_tables(self, c: int):
        """Window-shifted MSM tables, cached on disk per SRS identity:
        building them on device costs hundreds of batched doublings +
        inversions; the ~0.4 GB npz loads in seconds."""
        path = old = None
        if self.cache_dir is not None:
            base = f"msm_tables_{self.k}_{self.identity_tag()}_c{c}"
            path = os.path.join(self.cache_dir, base + "_v2.npz")
            old = os.path.join(self.cache_dir, base + ".npz")
            if os.path.exists(path):
                return jnp.asarray(np.load(path)["txy"])
        if old is not None and os.path.exists(old):
            # convert a round-2 (tx, ty) cache to the interleaved format
            z = np.load(old)
            txy = np.concatenate([z["tx"], z["ty"]], axis=1)
        else:
            txy = np.asarray(MSM.build_tables((self.g1_x, self.g1_y), c))
        if path is not None:
            np.savez(path, txy=txy)
        return jnp.asarray(txy)


def _tag_from_host(gx_head: np.ndarray, gy_head: np.ndarray, s_g2) -> str:
    h = hashlib.blake2b(digest_size=8)
    h.update(np.ascontiguousarray(gx_head[:4]).tobytes())
    h.update(np.ascontiguousarray(gy_head[:4]).tobytes())
    h.update(repr(s_g2).encode())
    return h.hexdigest()


def _host_window_tables(c: int = _WINDOW):
    """T[w][d] = d * 2^(c*w) * G1 as (nwin, 2^c, 2, 16) Montgomery limbs.

    d=0 rows are placeholders (masked to identity on device)."""
    nwin = _NWIN
    tables = np.zeros((nwin, 1 << c, 2, F.LIMBS), dtype=np.uint32)
    base = (CV.G1_X, CV.G1_Y)
    for w in range(nwin):
        acc = None
        for d in range(1, 1 << c):
            acc = CV.py_add(acc, base)
            tables[w, d, 0] = F.int_to_limbs(FQ.to_mont_host(acc[0]))
            tables[w, d, 1] = F.int_to_limbs(FQ.to_mont_host(acc[1]))
        for _ in range(c):
            base = CV.py_add(base, base)
    return tables


_POINTS_CHUNK = 1 << 17


def _points_from_scalars(scalars_plain):
    """[s_0, s_1, ...] plain ints -> affine ([s_i] G1) limb arrays,
    computed with batched fixed-window table sums on device.  All
    scalars must be nonzero mod r (no identity outputs).

    Tiny inputs (toy-circuit SRS in tests and the multichip dryrun)
    compute on HOST instead: the device path's one-time XLA compile is
    ~a minute on the single-CPU host, vs < 1 s of bigint math for a few
    hundred points.

    Processed in 2^17-scalar chunks: the windowed gather holds
    nwin x chunk points, and one monolithic k=20 batch wants ~34 GB
    of device memory."""
    total = len(scalars_plain)
    if total <= 512:
        pts = [CV.py_mul((CV.G1_X, CV.G1_Y), int(s) % FR.modulus)
               for s in scalars_plain]
        xs = F.ints_to_limbs_fast([FQ.to_mont_host(x) for x, _ in pts])
        ys = F.ints_to_limbs_fast([FQ.to_mont_host(y) for _, y in pts])
        return jnp.asarray(xs), jnp.asarray(ys)
    if total > _POINTS_CHUNK:
        xs, ys = [], []
        for lo in range(0, total, _POINTS_CHUNK):
            x, y = _points_from_scalars(scalars_plain[lo : lo + _POINTS_CHUNK])
            xs.append(np.asarray(x))
            ys.append(np.asarray(y))
        return jnp.asarray(np.concatenate(xs)), jnp.asarray(np.concatenate(ys))
    limbs = jnp.asarray(F.ints_to_limbs_fast([int(s) for s in scalars_plain]))
    tables = jnp.asarray(_host_window_tables())
    digs = MSM.digit_matrix(limbs, _WINDOW)            # (nwin, n)
    return _combine_windows(digs, tables)


@jax.jit
def _combine_windows(digs, tables):
    """Window-table sum: module-level jit so repeat same-shape calls
    (SRS setup + the .srs writer's Lagrange table in one process) share
    ONE compile — a per-call inner jit recompiled the identical graph
    each time (~40 s per extra call on the CPU host)."""
    one = jnp.asarray(FQ.one_mont)
    # gather per-window points; digit-0 rows become the projective
    # identity class (0 : 1 : 0) — X masked to 0, Y to 1, Z to 0
    xs = []
    ys = []
    zs = []
    for w in range(_NWIN):
        pt = jnp.take(tables[w], digs[w], axis=0)   # (n, 2, 16)
        nz = (digs[w] != 0)[:, None]
        xs.append(jnp.where(nz, pt[:, 0], jnp.uint32(0)))
        ys.append(jnp.where(nz, pt[:, 1], one[None, :]))
        zs.append(jnp.where(nz, one[None, :], jnp.uint32(0)))
    pts = (jnp.stack(xs), jnp.stack(ys), jnp.stack(zs))  # (nwin, n, 16)
    proj = MSM._tree_add(pts)
    # projective -> affine (tau^i != 0 so no identities)
    zinv = F.batch_inv(FQ, proj[2])
    ax = F.mul(FQ, proj[0], zinv)
    ay = F.mul(FQ, proj[1], zinv)
    return ax, ay


def _gen_g1_powers(k: int, tau: int):
    """[tau^i] G1 for i < 2^k, computed with one batched window-table sum."""
    n = 1 << k
    scal = []
    acc = 1
    for _ in range(n):
        scal.append(acc)
        acc = acc * tau % FR.modulus
    return _points_from_scalars(scal)


def setup(k: int, seed: bytes = b"halo2_aes_tpu dev srs",
          cache_dir: str | None = "ptau") -> SRS:
    """Deterministic dev SRS (cached).  NOT a trusted setup."""
    tau = int.from_bytes(
        hashlib.blake2b(seed, digest_size=64).digest(), "little"
    ) % FR.modulus
    g1_extra = CV.py_mul((CV.G1_X, CV.G1_Y), pow(tau, 1 << k, FR.modulus))
    path = None
    if cache_dir is not None:
        tag = hashlib.blake2b(seed, digest_size=8).hexdigest()
        path = os.path.join(cache_dir, f"kzg_bn254_{k}_{tag}.npz")
        if os.path.exists(path):
            z = np.load(path)
            s_g2 = PR.g2_mul(PR.G2, tau)
            srs = SRS(k, jnp.asarray(z["g1_x"]), jnp.asarray(z["g1_y"]),
                      PR.G2, s_g2, cache_dir=cache_dir, g1_extra=g1_extra)
            object.__setattr__(
                srs, "_tag", _tag_from_host(z["g1_x"], z["g1_y"], s_g2))
            return srs
    g1_x, g1_y = _gen_g1_powers(k, tau)
    srs = SRS(k, g1_x, g1_y, PR.G2, PR.g2_mul(PR.G2, tau),
              cache_dir=cache_dir, g1_extra=g1_extra)
    if path is not None:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(path, g1_x=np.asarray(g1_x), g1_y=np.asarray(g1_y))
    return srs

"""Runtime sanitizers: limb-canonicity + transcript-determinism checks.

Role of SURVEY.md §5.2 (the reference relies on safe Rust + debug
overflow checks; a limb-decomposed field stack has no such net):
with ``HALO2_SANITIZE=1`` the prover validates, at every phase
boundary, that the tensors it is about to commit are canonical field
elements (every 16x16-bit limb vector < r).  A non-canonical limb
vector is the limb-arithmetic analog of a NaN — downstream Montgomery
ops silently wrap and the proof fails verification with no indication
of where the corruption happened.

Determinism: seeded proves must be byte-reproducible (tests assert
proof bytes are identical across runs and across crash-resume); the
sanitizer adds the data-side half, catching nondeterministic kernels
before they surface as one-in-N verification failures.
"""

from __future__ import annotations

import os

import numpy as np

from halo2_aes_tpu.ops import field as F


class SanitizeError(AssertionError):
    """A sanitizer invariant failed (non-canonical limbs, bad shape)."""


def enabled() -> bool:
    return os.environ.get("HALO2_SANITIZE") == "1"


def noncanonical_count(field_cls, arr) -> int:
    """Number of rows of ``arr`` (m, LIMBS) that are >= the modulus or
    exceed 16 bits per limb.  Host-synced (debug tool, not a hot path)."""
    a = np.asarray(arr)
    if a.ndim != 2 or a.shape[1] != F.LIMBS:
        raise SanitizeError(f"expected (m, {F.LIMBS}) limbs, got {a.shape}")
    overflow = (a >> 16).any(axis=1)
    mod = np.asarray(F.int_to_limbs(field_cls.modulus), dtype=np.uint32)
    lt = np.zeros(a.shape[0], bool)
    gt = np.zeros(a.shape[0], bool)
    for i in range(F.LIMBS - 1, -1, -1):
        li, ri = a[:, i], mod[i]
        lt |= ~gt & (li < ri)
        gt |= ~lt & (li > ri)
    return int((~lt | overflow).sum())


def check_canonical(field_cls, arr, name: str) -> None:
    bad = noncanonical_count(field_cls, arr)
    if bad:
        raise SanitizeError(
            f"{name}: {bad} non-canonical limb vector(s) "
            f"(>= modulus or limb overflow)")


def check_phase(field_cls, name: str, **tensors) -> None:
    """Sanitize a prover phase's output tensors when HALO2_SANITIZE=1."""
    if not enabled():
        return
    for tname, t in tensors.items():
        if t is None or getattr(t, "shape", (0,))[0] == 0:
            continue
        check_canonical(field_cls, t, f"{name}.{tname}")

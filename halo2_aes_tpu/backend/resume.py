"""Per-phase prove checkpointing (crash/OOM-restartable proving).

Role: SURVEY.md §5.3 — the reference has no failure recovery at all;
a prover at k=20 scale can lose many minutes of NTT/MSM work to a
single out-of-memory failure in a late phase, so each heavy phase's outputs
(coefficient tensors + commitment points + blinding-RNG state) are
persisted and a rerun of ``prove(..., checkpoint_dir=...)`` replays the
Fiat-Shamir absorb sequence from the saved points and resumes compute
at the first incomplete phase.

The blake2b transcript state itself is not serializable, but every
absorption is a deterministic function of (vk digest, instances, saved
commitment points), so resume re-absorbs instead of restoring hash
state.  Blinding: with a seeded RNG the post-phase generator state is
saved so resumed draws continue the same stream; with the default
CSPRNG (seed=None) later draws are simply fresh, which is sound — the
restored phases' blinding is already fixed in their saved outputs.

Checkpoints key on (vk digest, witness bytes, instances, seed,
multiopen) so a stale directory can never splice mismatched phases.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from halo2_aes_tpu.backend.transcript import point_from_bytes, point_to_bytes

# absorb/compute order of the checkpointable phases
PHASES = ("advice", "lookup", "products", "quotient")


class ProveCheckpoint:
    """One prove attempt's phase store under ``dir/prove_<key>/``."""

    def __init__(self, root: str, key_material: bytes):
        h = hashlib.blake2b(key_material, digest_size=12)
        self.dir = os.path.join(root, f"prove_{h.hexdigest()}")
        os.makedirs(self.dir, exist_ok=True)

    def _paths(self, phase: str):
        return (os.path.join(self.dir, f"{phase}.npz"),
                os.path.join(self.dir, f"{phase}.json"))

    def load(self, phase: str):
        """Returns (arrays: dict[str, np.ndarray], points, rng_state)
        or None.  A half-written checkpoint (crash during save) loads
        as None because the .json marker is written last."""
        npz_path, meta_path = self._paths(phase)
        if not os.path.exists(meta_path):
            return None
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            data = np.load(npz_path)
            arrays = {k: data[k] for k in data.files}
        except Exception:
            return None
        points = [point_from_bytes(bytes.fromhex(p)) for p in meta["points"]]
        return arrays, points, meta.get("rng_state")

    def save(self, phase: str, arrays: dict, points, rng=None) -> None:
        npz_path, meta_path = self._paths(phase)
        np.savez(npz_path, **{k: np.asarray(v) for k, v in arrays.items()})
        meta = {
            "points": [point_to_bytes(p).hex() for p in points],
            "rng_state": _rng_state(rng),
        }
        tmp = meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, meta_path)  # marker lands atomically, last

    def clear(self) -> None:
        for phase in PHASES:
            for p in self._paths(phase):
                if os.path.exists(p):
                    os.remove(p)


def _rng_state(rng):
    if rng is None:
        return None
    st = rng.bit_generator.state
    # np Generator state dicts hold ints/strs/lists — JSON-safe after
    # converting the (possibly uint64-typed) state arrays
    return json.loads(json.dumps(st, default=lambda o: o.tolist()))


def restore_rng(rng, state) -> None:
    if rng is not None and state is not None:
        rng.bit_generator.state = state


def prove_key_material(vk_digest: int, values_np: np.ndarray, instances,
                       seed, multiopen: str,
                       lookup_sort: str = "field") -> bytes:
    h = hashlib.blake2b(b"halo2_aes_tpu prove ckpt v1", digest_size=32)
    h.update(int(vk_digest).to_bytes(32, "little"))
    h.update(np.ascontiguousarray(values_np).tobytes())
    for vals in instances:
        h.update(b"i")
        for v in vals:
            h.update(int(v).to_bytes(8, "little"))
    h.update(repr(seed).encode())
    h.update(multiopen.encode())
    h.update(lookup_sort.encode())
    return h.digest()

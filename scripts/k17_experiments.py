"""One-process k=17 experiment battery (r5 measurement program).

Warm-up is paid ONCE (the k=17 pipeline's compiles), then:
  1. steady-state proves with lookup_sort=field (the flagship config),
  2. a HALO2_PROVE_TIMING=2 phase-profiled prove (queue-serialized,
     accurate per-phase attribution),
  3. the same battery with lookup_sort=packed — the host-precomputed
     table sort that has been plumbed since r3 but never timed on the
     chip (VERDICT r4 task 2).

Usage: python scripts/k17_experiments.py [k] [blocks] [sets] [--tagged]
           [--field-only]

--tagged runs the LEAN circuit (AesConfig.tagged_ops).  --field-only
skips the packed leg (each extra sort mode costs fresh lookup-phase
compiles on an untried config).
"""

import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax

from halo2_aes_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from halo2_aes_tpu.backend import srs as SRS
from halo2_aes_tpu.backend.keygen import keygen_cached
from halo2_aes_tpu.backend.prover import prove
from halo2_aes_tpu.backend.verifier import verify
from halo2_aes_tpu.circuit import witness
from halo2_aes_tpu.models.aes128 import AesConfig, compile_circuit


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    tagged = "--tagged" in sys.argv
    k = int(args[0]) if len(args) > 0 else 17
    blocks = int(args[1]) if len(args) > 1 else 96
    sets = int(args[2]) if len(args) > 2 else 1

    t0 = time.perf_counter()
    layout = compile_circuit(AesConfig(k=k, n_sets=sets, n_blocks=blocks,
                                       tagged_ops=tagged))
    srs = SRS.setup(k)
    pk = keygen_cached(layout, srs)
    print(f"setup+keygen {time.perf_counter()-t0:.1f}s", flush=True)

    rng = np.random.default_rng(0)
    key = rng.integers(0, 256, 16, dtype=np.uint8)
    pts = rng.integers(0, 256, (blocks, 16), dtype=np.uint8)
    pool = witness.build_pool(jnp.asarray(key), jnp.asarray(pts))
    values = jax.block_until_ready(witness.assemble_values(layout, pool))

    sorts = ("field",) if "--field-only" in sys.argv else ("field",
                                                           "packed")
    for sort in sorts:
        t0 = time.perf_counter()
        proof = prove(pk, values, seed=1, lookup_sort=sort)
        print(f"[{sort}] warm-up {time.perf_counter()-t0:.1f}s", flush=True)
        times = []
        for s in (2, 3, 4):
            t0 = time.perf_counter()
            proof = prove(pk, values, seed=s, lookup_sort=sort)
            times.append(time.perf_counter() - t0)
        best = min(times)
        print(f"[{sort}] proves {['%.2f' % t for t in times]}s; best "
              f"{best:.2f}s = {blocks/best:.3f} blocks/s", flush=True)
        t0 = time.perf_counter()
        verify(pk.vk, proof)
        print(f"[{sort}] verify {time.perf_counter()-t0:.2f}s ok "
              f"({len(proof)} bytes)", flush=True)
        os.environ["HALO2_PROVE_TIMING"] = "2"
        t0 = time.perf_counter()
        prove(pk, values, seed=5, lookup_sort=sort)
        print(f"[{sort}] profiled prove total "
              f"{time.perf_counter()-t0:.2f}s (queue-serialized)",
              flush=True)
        del os.environ["HALO2_PROVE_TIMING"]


if __name__ == "__main__":
    main()

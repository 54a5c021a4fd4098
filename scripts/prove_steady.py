"""Steady-state AES prove timing: compile-warm pipeline, then timed proves.

Usage: python scripts/prove_steady.py [k] [blocks] [sets]
           [--tagged] [--lookup-sort=field|packed]

--tagged selects the LEAN circuit (AesConfig.tagged_ops: one fused
tagged-op lookup per set instead of the reference's per-op lookups).

--lookup-sort picks the permuted-pair ordering: "field" (default;
halo2's canonical-field-value sort, on-device radix argsort) or
"packed" (host-precomputed byte-tuple sort — cheaper, different proof
bytes, same argument).
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


KNOWN_FLAGS = {"--tagged", "--lookup-sort=field", "--lookup-sort=packed"}


def main():
    unknown = [a for a in sys.argv[1:]
               if a.startswith("--") and a not in KNOWN_FLAGS]
    if unknown:
        sys.exit(f"prove_steady.py: unknown flags {unknown}; "
                 f"known: {sorted(KNOWN_FLAGS)}")
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    k = int(args[0]) if len(args) > 0 else 17
    blocks = int(args[1]) if len(args) > 1 else 4
    sets = int(args[2]) if len(args) > 2 else 1
    tagged = "--tagged" in sys.argv
    lookup_sort = ("packed" if "--lookup-sort=packed" in sys.argv
                   else "field")

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

    t0 = time.perf_counter()
    proof = prove(pk, values, seed=1, lookup_sort=lookup_sort)
    print(f"prove#1 (cold) {time.perf_counter()-t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    proof = prove(pk, values, seed=2, lookup_sort=lookup_sort)
    dt = time.perf_counter() - t0
    print(f"prove#2 (warm) {dt:.1f}s = {blocks/dt:.3f} blocks/s", flush=True)
    t0 = time.perf_counter()
    proof = prove(pk, values, seed=3, lookup_sort=lookup_sort)
    dt = time.perf_counter() - t0
    print(f"prove#3 (steady) {dt:.1f}s = {blocks/dt:.3f} blocks/s", flush=True)
    t0 = time.perf_counter()
    verify(pk.vk, proof)
    print(f"verify {time.perf_counter()-t0:.2f}s ok", flush=True)


if __name__ == "__main__":
    main()

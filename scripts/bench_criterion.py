"""Criterion-style statistical prove benchmarks.

Role of the reference's criterion harnesses (reference
benches/aes128.rs:85-119 and benches/key_schedule.rs:105-137,
SAMPLE_SIZE=10): repeated timed proves of (a) the full AES-128 circuit
and (b) the key-schedule-only circuit (n_blocks=0), reporting
mean/std/min/max over n samples after a warm-up prove pays the
compiles.  Unlike the reference's AES bench, the requested block count
is validated against capacity (the checked-in reference bench panics:
6000 > 3853, benches/aes128.rs:90).

Usage: python scripts/bench_criterion.py [--k 17] [--blocks 16]
           [--sets 1] [--samples 5] [--key-schedule-only]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=17)
    ap.add_argument("--blocks", type=int, default=16)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--samples", type=int, default=5)
    ap.add_argument("--key-schedule-only", action="store_true")
    args = ap.parse_args()

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

    blocks = 0 if args.key_schedule_only else args.blocks
    name = "key_schedule_prove" if args.key_schedule_only else "aes128_prove"
    cfg = AesConfig(k=args.k, n_sets=args.sets, n_blocks=blocks)
    layout = compile_circuit(cfg)
    srs = SRS.setup(args.k)
    pk = keygen_cached(layout, srs)

    rng = np.random.default_rng(0)
    key = rng.integers(0, 256, 16, dtype=np.uint8)
    pts = rng.integers(0, 256, (blocks, 16), dtype=np.uint8)
    pool = witness.build_pool(jnp.asarray(key), jnp.asarray(pts))
    values = jax.block_until_ready(witness.assemble_values(layout, pool))

    proof = prove(pk, values)  # warm-up
    verify(pk.vk, proof)

    times = []
    for _ in range(args.samples):
        t0 = time.perf_counter()
        prove(pk, values)
        times.append(time.perf_counter() - t0)

    out = {
        "bench": name,
        "k": args.k,
        "n_sets": args.sets,
        "blocks_per_proof": blocks,
        "samples": args.samples,
        "mean_s": round(statistics.mean(times), 3),
        "std_s": round(statistics.pstdev(times), 3),
        "min_s": round(min(times), 3),
        "max_s": round(max(times), 3),
        "proof_bytes": len(proof),
    }
    if blocks:
        out["blocks_per_sec"] = round(blocks / statistics.mean(times), 3)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

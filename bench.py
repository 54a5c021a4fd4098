"""Benchmark: steady-state AES-128 proving throughput on one GPU.

Run from the repository root on a machine with the card:

    python bench.py

One process sets up the k=17, n_sets=4, 384-block circuit (the
circuit's full capacity at k=17, with the tagged lookups), proves once to
pay the compiles, times one warm KZG/SHPLONK prove, verifies that proof
and prints ONE JSON line naming the device, the card and its power
limit.  Prover cost is bound by the domain size, so the circuit is full,
as the reference driver fills its own (reference src/main.rs:25).  Any
failure — no GPU included — exits non-zero without printing a metric.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

K, N_SETS, BLOCKS, TAGGED_OPS = 17, 4, 384, True


def main() -> None:
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench: needs a GPU; JAX found platform "
                         f"{devs[0].platform!r}")
    card_name, power_limit = (s.strip() for s in subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.splitlines()[0].split(","))

    from halo2_aes_tpu import prove
    from halo2_aes_tpu.utils import cost_model

    st = prove.setup(K, N_SETS, BLOCKS, tagged_ops=TAGGED_OPS)
    be, pk = st["backend"], st["pk"]
    t0 = time.perf_counter()
    be.prove(pk, st["values"])                       # compiles
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof = be.prove(pk, st["values"])
    dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    be.verify(pk.vk, proof)
    verify_s = time.perf_counter() - t0
    muls = cost_model.field_muls(st["layout"])["total"]
    print(json.dumps({
        "metric": f"aes128_prove_blocks_per_sec_k{K}_warm",
        "value": BLOCKS / dt,
        "unit": "blocks/s",
        "prove_seconds": dt,
        "first_prove_seconds": first,
        "setup_seconds": st["timings"],
        "verify_seconds": verify_s,
        "blocks_per_proof": BLOCKS,
        "n_sets": N_SETS,
        "tagged_ops": TAGGED_OPS,
        "proof_bytes": len(proof),
        "field_muls_per_proof": muls,
        "peak_bytes_in_use": devs[0].memory_stats()["peak_bytes_in_use"],
        "verified": True,
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "card": card_name,
        "power_limit": power_limit,
    }))


if __name__ == "__main__":
    main()

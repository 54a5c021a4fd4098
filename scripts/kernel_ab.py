"""Warm prove with and without the CUDA field and G1 kernels.

Runs on a GPU from the repository root (one process, one card):

    python scripts/kernel_ab.py [--k 17] [--sets 4] [--blocks 384]
                                [--out chiprun_out/kernel_ab.json]

Sets up the circuit once, then proves in the order kernel, plain, plain,
kernel (two proves each: the first compiles, the second is the warm
time), verifying every proof.  "Plain" makes ``gpu_field.use_kernels``
answer False so every operation takes the XLA path; the jit caches are
cleared between arms so each arm traces its own graphs.  Each arm's
proofs must verify.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k", type=int, default=17)
    ap.add_argument("--sets", type=int, default=4)
    ap.add_argument("--blocks", type=int, default=384)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import jax

    from halo2_aes_tpu import prove
    from halo2_aes_tpu.ops import gpu_field as G
    from halo2_aes_tpu.ops import ntt as NTT

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"kernel_ab: needs a GPU, found {dev.platform!r}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    st = prove.setup(args.k, args.sets, args.blocks, expose_ciphertext=True)
    be, pk = st["backend"], st["pk"]
    chosen = G.use_kernels
    runs = []
    for arm in ("kernel", "plain", "plain", "kernel"):
        G.use_kernels = chosen if arm == "kernel" else (lambda *a, **k: False)
        jax.clear_caches()
        NTT._ntt_jit.cache_clear()
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            proof = be.prove(pk, st["values"])
            times.append(time.perf_counter() - t0)
        be.verify(pk.vk, proof, instances=st["instances"])
        runs.append({"arm": arm, "first_s": times[0], "warm_s": times[1]})
        print(json.dumps(runs[-1]), flush=True)
    G.use_kernels = chosen
    out = {"device_kind": dev.device_kind, "nvidia_smi": smi,
           "k": args.k, "n_sets": args.sets, "blocks": args.blocks,
           "setup_timings": st["timings"], "runs": runs}
    print(json.dumps(out))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()

"""Multi-PROCESS prover collectives: the multi-host (DCN) analog on one box.

The reference scales only by rayon threads in shared memory
(SURVEY.md section 2.13 item 5); this build's scaling axis is a
device mesh that may span hosts (SURVEY.md section 5.8, BASELINE
config 5).  This driver demonstrates the *process-boundary* path that
multi-host execution exercises: N separate Python processes, each
owning a slice of the mesh, joined through ``jax.distributed`` — the
same runtime machinery a multi-host deployment uses, with the CPU
backend's cross-process collectives standing in for the interconnect.

What runs over the 2-process x 4-device global mesh:
  * the four-step distributed NTT (parallel/ntt.py) — its
    column->row reshard is an all-to-all that here crosses the
    process boundary — checked shard-by-shard against the
    single-device transform;
  * the point-sharded collective MSM (parallel/msm.py) — partial
    Pippenger sums all_gather'ed and tree-reduced — checked against
    the python-bigint oracle.

Usage:  python scripts/multihost_demo.py            # parent: spawns 2 workers
        (workers are re-invocations with --proc/--coord, not for direct use)
"""

from __future__ import annotations

import argparse
import os
import pathlib
import socket
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

NPROCS = 2
LOCAL_DEVICES = 4


def worker(coord: str, pid: int) -> None:
    import jax

    jax.distributed.initialize(
        coordinator_address=coord, num_processes=NPROCS, process_id=pid
    )
    import jax.numpy as jnp
    import numpy as np

    from halo2_aes_tpu.ops import curve as CV
    from halo2_aes_tpu.ops import field as F
    from halo2_aes_tpu.ops import msm as M
    from halo2_aes_tpu.parallel import msm as pmsm
    from halo2_aes_tpu.parallel import ntt as pntt


    devices = jax.devices()
    assert len(devices) == NPROCS * LOCAL_DEVICES, devices
    assert len(jax.local_devices()) == LOCAL_DEVICES
    from jax.sharding import Mesh

    mesh = Mesh(np.array(devices), axis_names=("dp",))

    # --- distributed NTT, all-to-all across the process boundary ---
    k = 10
    dom = pntt.domain(F.FR, k)
    coeffs = np.asarray(F.FR.encode(list(range(1 << k))), dtype=np.uint32)
    out = pntt.ntt_sharded(mesh, "dp", dom, coeffs)

    # expected: the single-device transform on this process's devices
    local = jax.device_put(jnp.asarray(coeffs), jax.local_devices()[0])
    expected = np.asarray(jax.jit(lambda v: pntt.ntt(dom, v))(local))
    for shard in out.addressable_shards:
        np.testing.assert_array_equal(np.asarray(shard.data), expected[shard.index])

    back = pntt.ntt_sharded(mesh, "dp", dom, out, inverse=True)
    for shard in back.addressable_shards:
        np.testing.assert_array_equal(np.asarray(shard.data), coeffs[shard.index])

    # --- collective MSM, partial sums gathered across processes ---
    n = 64
    rng = np.random.default_rng(7)
    g = (CV.G1_X, CV.G1_Y)
    pts = [CV.py_mul(g, int(rng.integers(1, 1 << 61))) for _ in range(n)]
    scalars = [int(rng.integers(0, 1 << 63)) for _ in range(n)]
    px, py = CV.affine_from_ints(pts)
    out_pt = pmsm.msm_sharded(
        mesh, "dp", (np.asarray(px), np.asarray(py)),
        np.asarray(F.ints_to_limbs_fast(scalars)), c=6,
    )
    got = CV.to_affine_host(tuple(np.asarray(c) for c in out_pt))[0]
    assert got == M.msm_host(pts, scalars), (got, pid)

    print(f"proc {pid}: ntt+msm collectives ok across {NPROCS} processes",
          flush=True)


def parent() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=(env.get("XLA_FLAGS", "")
                   + f" --xla_force_host_platform_device_count={LOCAL_DEVICES}"),
    )
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--coord", coord, "--proc", str(i)],
            env=env, cwd=str(REPO),
        )
        for i in range(NPROCS)
    ]
    rcs = [p.wait(timeout=600) for p in procs]
    if any(rcs):
        print(f"FAILED: worker exit codes {rcs}", file=sys.stderr)
        return 1
    print(f"multihost demo ok: {NPROCS} processes x {LOCAL_DEVICES} devices")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coord")
    ap.add_argument("--proc", type=int)
    args = ap.parse_args()
    if args.coord is None:
        return parent()
    worker(args.coord, args.proc)
    return 0


if __name__ == "__main__":
    sys.exit(main())

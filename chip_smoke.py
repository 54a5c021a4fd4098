"""Smoke test of the prover on an NVIDIA GPU.

Run from the repository root on a machine with the card:

    python chip_smoke.py          # one card: device, kernels, main path
    python chip_smoke.py --four   # four cards: sharded k=17 prove vs one card

Phases (one card): the device check; the ``gpu``-marked kernel tests
(tests/test_kernels.py: the CUDA field and G1 kernels built with nvcc,
run at real width, bit-exact against XLA and the bigint oracle, timed
beside XLA, and found in the compiled HLO of the prover's NTT and MSM
executables); the k=17, n_sets=4, 384-block AES-128
KZG/SHPLONK prove through ``halo2_aes_tpu.prove.run`` with the
ciphertext exposed and verified, plus a tampered proof that must fail.
With ``--four`` the only phases are the device check and the sharded
prove on a one-axis mesh of four cards, which must verify and match the
one-card proof with the same blinding seed byte for byte.

Each phase prints its result; the last line of a passing run is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from halo2_aes_tpu.backend.verifier import VerifyError  # noqa: E402

K, N_SETS, BLOCKS = 17, 4, 384     # the circuit's full capacity at k=17


def device_phase(n_cards: int) -> dict:
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX found platform "
                         f"{devs[0].platform!r}")
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} cards, found "
                         f"{len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"device: {devs[0].device_kind}, {len(devs)} device(s)")
    for line in smi.strip().splitlines():
        print(f"nvidia-smi: {line.strip()}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


class _Outcomes:
    """pytest plugin counting test outcomes."""

    def __init__(self):
        self.passed = self.failed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.failed:
            self.failed += 1
        elif report.skipped:
            self.skipped += 1
        elif report.when == "call":
            self.passed += 1


def kernel_phase() -> None:
    import pytest

    os.environ["HALO2_TEST_ON_CARD"] = "1"
    out = _Outcomes()
    rc = pytest.main(["-q", "-s", "-p", "no:cacheprovider", "-m", "gpu",
                      os.path.join(REPO, "tests", "test_kernels.py")],
                     plugins=[out])
    if rc != 0 or out.failed or out.skipped or not out.passed:
        raise SystemExit(f"chip_smoke: kernel tests rc={rc}: {out.passed} "
                         f"passed, {out.failed} failed, {out.skipped} "
                         f"skipped")
    print(f"kernels: {out.passed} gpu tests passed")


def main_path_phase() -> None:
    import jax

    from halo2_aes_tpu import prove

    res = prove.run(K, N_SETS, BLOCKS, do_verify=True,
                    expose_ciphertext=True, proves=2)
    t = res["timings"]
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    print(f"main path: k={K} n_sets={N_SETS} blocks={BLOCKS}: srs "
          f"{t['srs_setup']} s, keygen {t['keygen']} s, compile+first "
          f"prove {t['prove']} s, warm prove {t['prove_warm']} s, verify "
          f"{t['verify']} s, proof {res['proof_bytes']} bytes, peak device "
          f"memory {peak} bytes; proof verified against the host AES "
          f"ciphertexts")
    bad = bytearray(res["proof"])
    bad[len(bad) // 2] ^= 1
    from halo2_aes_tpu.backend import get_backend

    try:
        get_backend("kzg-shplonk").verify(res["vk"], bytes(bad),
                                          instances=res["instances"])
    except VerifyError as e:
        print(f"tampered proof rejected: {e}")
    else:
        raise SystemExit("chip_smoke: a tampered proof verified")


def sharded_vs_single(st: dict, mesh, seed: int = 7) -> None:
    """Prove once on a mesh and once on one device with the same blinding
    seed; the sharded proof must verify and match byte for byte."""
    be, pk, values = st["backend"], st["pk"], st["values"]
    t0 = time.perf_counter()
    sharded = be.prove(pk, values, seed=seed, mesh=mesh, mesh_axis="dp")
    t1 = time.perf_counter()
    be.verify(pk.vk, sharded, instances=st["instances"])
    print(f"sharded prove on {mesh.devices.size} devices (compile+prove "
          f"{t1 - t0:.3f} s) verified, {len(sharded)} bytes", flush=True)
    t1 = time.perf_counter()
    single = be.prove(pk, values, seed=seed)
    t2 = time.perf_counter()
    if sharded != single:
        raise SystemExit("chip_smoke: sharded proof differs from the "
                         "one-device proof")
    print(f"the sharded proof is byte-identical to the one-device proof "
          f"(compile+prove {t2 - t1:.3f} s)")


def four_phase() -> None:
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from halo2_aes_tpu import prove

    st = prove.setup(K, N_SETS, BLOCKS, expose_ciphertext=True)
    sharded_vs_single(st, Mesh(np.array(jax.devices()[:4]), ("dp",)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded prove on four cards and the "
                         "one-card prove it is compared with")
    args = ap.parse_args()
    device = device_phase(4 if args.four else 1)
    if args.four:
        four_phase()
    else:
        kernel_phase()
        main_path_phase()
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()

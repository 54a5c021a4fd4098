"""Quick prove->verify smoke test on the toy circuit (see verify skill)."""

import sys
import time
import pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from tests.test_prove_verify import toy_circuit, K  # noqa: E402


def main():
    from halo2_aes_tpu.backend import srs as SRS
    from halo2_aes_tpu.backend.keygen import keygen
    from halo2_aes_tpu.backend.prover import prove
    from halo2_aes_tpu.backend.verifier import verify

    layout, values = toy_circuit()
    t0 = time.perf_counter()
    srs = SRS.setup(K, cache_dir=None)
    pk = keygen(layout, srs)
    print(f"keygen {time.perf_counter()-t0:.1f}s")
    t0 = time.perf_counter()
    proof = prove(pk, values, seed=7)
    print(f"prove {time.perf_counter()-t0:.1f}s ({len(proof)} bytes)")
    t0 = time.perf_counter()
    verify(pk.vk, proof)
    print(f"verify {time.perf_counter()-t0:.1f}s: ok")


if __name__ == "__main__":
    main()

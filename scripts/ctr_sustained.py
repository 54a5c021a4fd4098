"""Config-5 sustained AES-CTR proving measurement (BASELINE.json).

Proves a long CTR keystream as a bundle of full-capacity proofs on the
attached chip, verifies the WHOLE bundle with one pairing-product check,
and prints sustained blocks/s + an honest 64K-block extrapolation.

Usage: python scripts/ctr_sustained.py [n_blocks] [k] [sets] [--tagged]
Defaults: 4096 blocks at k=17, n_sets=1 (bpp=96 -> 43 proofs).
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from halo2_aes_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

import numpy as np

from halo2_aes_tpu import ctr
from halo2_aes_tpu.backend import srs as SRS
from halo2_aes_tpu.backend.keygen import keygen_cached
from halo2_aes_tpu.models.aes128 import AesConfig, capacities, compile_circuit, configure


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    tagged = "--tagged" in sys.argv
    n_blocks = int(args[0]) if len(args) > 0 else 4096
    k = int(args[1]) if len(args) > 1 else 17
    sets = int(args[2]) if len(args) > 2 else 1

    cfg0 = AesConfig(k=k, n_sets=sets, n_blocks=1, expose_ciphertext=True,
                     tagged_ops=tagged)
    bpp = sum(capacities(cfg0, configure(cfg0)[0]))
    cfg = AesConfig(k=k, n_sets=sets, n_blocks=bpp, expose_ciphertext=True,
                    tagged_ops=tagged)
    print(f"bpp={bpp} chunks={-(-n_blocks // bpp)}", flush=True)
    layout = compile_circuit(cfg)
    srs = SRS.setup(k)
    pk = keygen_cached(layout, srs)

    key = np.frombuffer(
        bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c"), np.uint8)
    nonce = bytes(range(12))

    # warm-up: one full chunk pays every compile
    t0 = time.perf_counter()
    ctr.prove_keystream(pk, key, nonce, n_blocks=1)
    print(f"warmup chunk {time.perf_counter()-t0:.1f}s", flush=True)

    done = [0.0]

    def progress(i, total):
        now = time.perf_counter() - t0
        print(f"proof {i}/{total} t={now:.1f}s "
              f"({i*bpp/now:.2f} blocks/s sustained)", flush=True)
        done[0] = now

    t0 = time.perf_counter()
    bundle = ctr.prove_keystream(pk, key, nonce, n_blocks=n_blocks,
                                 progress=progress)
    prove_s = done[0]
    t0v = time.perf_counter()
    assert ctr.verify_bundle(pk.vk, bundle)
    verify_s = time.perf_counter() - t0v
    bps = n_blocks / prove_s
    print(f"SUSTAINED: {n_blocks} blocks in {prove_s:.1f}s = "
          f"{bps:.2f} blocks/s; bundle verify ({len(bundle.proofs)} proofs, "
          f"one pairing product) {verify_s:.2f}s", flush=True)
    print(f"64K-block extrapolation: {65536/bps/60:.1f} min prove, "
          f"verify ~{verify_s*65536/n_blocks:.1f}s", flush=True)


if __name__ == "__main__":
    main()

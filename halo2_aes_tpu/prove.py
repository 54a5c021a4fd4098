"""End-to-end AES-128 prove (+verify) driver.

Role of the reference's prove binary (reference src/main.rs:83-108:
K=20/N=4, 3000 encrypts, SRS cache, ark-std timers) — with the verify
step the reference lacks.

Usage:
  python -m halo2_aes_tpu.prove --k 17 --blocks 4 --sets 1 --verify

``run`` returns the timings and sizes as a JSON-able dict, plus the
proof, the verifying key and the public instances under ``ARTIFACTS``
keys (which ``main`` leaves out of its JSON line).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

ARTIFACTS = ("proof", "vk", "instances")


def setup(k: int, n_sets: int, blocks: int, seed: int = 0,
          srs_cache: str | None = "ptau", expose_ciphertext: bool = False,
          decrypt: bool = False, backend: str = "kzg-shplonk",
          tagged_ops: bool = False) -> dict:
    """Compile the circuit, set up the SRS and keys, build the witness.

    Returns {"backend", "layout", "pk", "values", "instances",
    "timings"}; the instances are the public bytes from the host AES
    oracle when ``expose_ciphertext`` (else None).  ``tagged_ops``
    selects the encryption circuit's fused lookups (AesConfig)."""
    import jax

    from halo2_aes_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()

    from halo2_aes_tpu.backend import get_backend
    from halo2_aes_tpu.circuit import witness
    from halo2_aes_tpu.models.aes128 import AesConfig, compile_circuit

    be = get_backend(backend)
    timings = {}
    timed = _timer(timings)

    with timed("compile_circuit"):
        if decrypt:
            from halo2_aes_tpu.models.aes128_dec import (
                AesDecConfig, compile_circuit as compile_dec)

            cfg = AesDecConfig(k=k, n_sets=n_sets, n_blocks=blocks,
                               expose_plaintext=expose_ciphertext)
            layout = compile_dec(cfg)
        else:
            cfg = AesConfig(k=k, n_sets=n_sets, n_blocks=blocks,
                            expose_ciphertext=expose_ciphertext,
                            tagged_ops=tagged_ops)
            layout = compile_circuit(cfg)
    with timed("srs_setup"):
        srs = be.setup_srs(k, cache_dir=srs_cache)
    with timed("keygen"):
        pk = be.keygen(layout, srs, cache_dir=srs_cache or 'ptau')

    rng = np.random.default_rng(seed)
    key = rng.integers(0, 256, 16, dtype=np.uint8)
    plaintexts = rng.integers(0, 256, (blocks, 16), dtype=np.uint8)

    with timed("witness"):
        import jax.numpy as jnp

        from halo2_aes_tpu.ops import aes

        if decrypt:
            # prove knowledge of the DECRYPTION of these ciphertexts
            cts = np.asarray(aes.encrypt(plaintexts, key))
            pool = witness.build_dec_pool(jnp.asarray(key), jnp.asarray(cts))
        else:
            pool = witness.build_pool(jnp.asarray(key),
                                      jnp.asarray(plaintexts))
        values = jax.block_until_ready(witness.assemble_values(layout, pool))
    instances = None
    if expose_ciphertext:
        # the verifier checks the proof binds to the TRUE public bytes,
        # computed with an independent oracle (ciphertext for encryption;
        # recovered plaintext for decryption)
        pub = (plaintexts if decrypt
               else np.asarray(aes.encrypt(plaintexts, key)))
        instances = [[int(v) for v in np.asarray(pub).reshape(-1)]]
    return {"backend": be, "layout": layout, "pk": pk, "values": values,
            "instances": instances, "timings": timings}


def _timer(timings: dict):
    def timed(name):
        class _T:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *a):
                timings[name] = round(time.perf_counter() - self.t0, 3)
                print(f"[{name}] {timings[name]}s", flush=True)

        return _T()

    return timed


def run(k: int, n_sets: int, blocks: int, do_verify: bool, seed: int = 0,
        srs_cache: str | None = "ptau", expose_ciphertext: bool = False,
        decrypt: bool = False,
        checkpoint_dir: str | None = None,
        backend: str = "kzg-shplonk", proves: int = 1) -> dict:
    """Set up, prove ``proves`` times and optionally verify.

    timings["prove"] is the first prove (it includes the XLA compiles);
    with ``proves > 1``, timings["prove_warm"] is the last one."""
    st = setup(k, n_sets, blocks, seed, srs_cache, expose_ciphertext,
               decrypt, backend)
    be, pk, timings = st["backend"], st["pk"], st["timings"]
    timed = _timer(timings)
    # NOTE: the data seed is NOT passed to prove(): blinding always
    # comes from the OS CSPRNG (reproducible blinding would leak
    # witness data; reference uses OsRng, src/main.rs:75).
    for i in range(proves):
        with timed("prove" if i == 0 else "prove_warm"):
            proof = be.prove(pk, st["values"], checkpoint_dir=checkpoint_dir)
    result = {"proof_bytes": len(proof), "timings": timings,
              "blocks": blocks, "k": k, "n_sets": n_sets,
              "mode": "decrypt" if decrypt else "encrypt",
              "proof": proof, "vk": pk.vk, "instances": st["instances"]}
    if do_verify:
        with timed("verify"):
            be.verify(pk.vk, proof, instances=st["instances"])
        result["verified"] = True
    return result


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--k", type=int, default=17)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--blocks", type=int, default=1)
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--expose-ciphertext", action="store_true",
                    help="expose the public bytes as an instance column "
                         "(ciphertext when encrypting, recovered plaintext "
                         "with --decrypt)")
    ap.add_argument("--decrypt", action="store_true",
                    help="prove AES-128 DECRYPTION (models/aes128_dec.py)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="persist per-phase prove checkpoints here and "
                         "resume a crashed prove (backend/resume.py)")
    ap.add_argument("--backend", default="kzg-shplonk",
                    choices=["kzg-shplonk", "kzg-gwc", "ipa"],
                    help="proving system (backend.get_backend): KZG with "
                         "SHPLONK or GWC multiopen, or the transparent "
                         "pairing-free IPA system (backend/ipa.py)")
    args = ap.parse_args()
    result = run(args.k, args.sets, args.blocks, args.verify, args.seed,
                 expose_ciphertext=args.expose_ciphertext,
                 decrypt=args.decrypt,
                 checkpoint_dir=args.checkpoint_dir, backend=args.backend)
    print(json.dumps({k: v for k, v in result.items() if k not in ARTIFACTS}))


if __name__ == "__main__":
    main()

"""Per-step warm keygen profile: where do the seconds go?

Usage: python scripts/keygen_profile.py [k] [blocks] [sets]
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    k = int(args[0]) if len(args) > 0 else 17
    blocks = int(args[1]) if len(args) > 1 else 16
    sets = int(args[2]) if len(args) > 2 else 1

    import jax

    from halo2_aes_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    t = time.perf_counter()

    def tick(name):
        nonlocal t
        now = time.perf_counter()
        print(f"{name}: {now - t:.2f}s", flush=True)
        t = now

    from halo2_aes_tpu.models.aes128 import AesConfig, compile_circuit

    layout = compile_circuit(AesConfig(k=k, n_sets=sets, n_blocks=blocks))
    tick("compile_circuit")

    from halo2_aes_tpu.backend import srs as SRS

    srs = SRS.setup(k)
    tick("srs_setup")

    from halo2_aes_tpu.backend import keygen as KG
    from halo2_aes_tpu.backend import permutation as PERM

    tag = KG.layout_fingerprint(layout)
    tick("layout_fingerprint")
    sid = KG.srs_identity(srs)
    tick("srs_identity")

    import os

    import numpy as np

    path = os.path.join("ptau", f"pk_{tag}_s{srs.k}_{sid}.npz")
    print("cache hit:", os.path.exists(path))
    z = np.load(path, allow_pickle=True)
    pre = {
        "fixed_comms": [None if pt[0] == "" else tuple(int(v) for v in pt)
                        for pt in z["fixed_comms"]],
        "sigma_comms": [None if pt[0] == "" else tuple(int(v) for v in pt)
                        for pt in z["sigma_comms"]],
        "assembly": PERM.PermutationAssembly(
            list(layout.cs.perm_columns), z["map_col"], z["map_row"]),
    }
    tick("load_pk_cache")

    import jax.numpy as jnp

    cs = layout.cs
    m_perm = len(cs.perm_columns)
    omega_pows, delta_pows = PERM._label_tables(k, max(m_perm, 1))
    tick("label_tables")

    fixed_ids = layout.fixed_ids()
    run = KG._keygen_jit(k, len(fixed_ids), m_perm, layout.usable_rows)
    fixed_stack = layout.fixed[fixed_ids]
    lowered = run.lower(
        jnp.asarray(fixed_stack),
        jnp.asarray(pre["assembly"].map_col, dtype=jnp.int32),
        jnp.asarray(pre["assembly"].map_row, dtype=jnp.int32),
        omega_pows, delta_pows)
    tick("keygen_jit_lower")
    compiled = lowered.compile()
    tick("keygen_jit_compile")
    out = compiled(
        jnp.asarray(fixed_stack),
        jnp.asarray(pre["assembly"].map_col, dtype=jnp.int32),
        jnp.asarray(pre["assembly"].map_row, dtype=jnp.int32),
        omega_pows, delta_pows)
    jax.block_until_ready(out)
    tick("keygen_jit_run")

    pk = KG.keygen_cached(layout, srs)
    tick("keygen_cached_total(after_warm)")
    _ = pk


if __name__ == "__main__":
    main()

"""Warm micro-profile of the quotient phase pieces + tabled MSM.

Usage: python scripts/quotient_profile.py [k] [blocks] [sets]
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
    import jax.numpy as jnp
    import numpy as np

    from halo2_aes_tpu.backend import prover as PV
    from halo2_aes_tpu.backend import srs as SRS
    from halo2_aes_tpu.backend.keygen import keygen_cached
    from halo2_aes_tpu.backend.prover import prove
    from halo2_aes_tpu.circuit import witness
    from halo2_aes_tpu.models.aes128 import AesConfig, compile_circuit
    from halo2_aes_tpu.ops import field as F
    from halo2_aes_tpu.ops.ntt import ntt_many

    FR = F.FR

    layout = compile_circuit(AesConfig(k=k, n_sets=sets, n_blocks=blocks))
    srs = SRS.setup(k)
    pk = keygen_cached(layout, srs)
    rng = np.random.default_rng(0)
    key = rng.integers(0, 256, 16, dtype=np.uint8)
    pts = rng.integers(0, 256, (blocks, 16), dtype=np.uint8)
    pool = witness.build_pool(jnp.asarray(key), jnp.asarray(pts))
    values = jax.block_until_ready(witness.assemble_values(layout, pool))

    t0 = time.perf_counter()
    prove(pk, values, seed=1)
    print(f"prove#1 {time.perf_counter()-t0:.1f}s", flush=True)

    ph = PV._get_phases(pk)
    n = ph.n

    def timed(name, fn, reps=3):
        out = jax.block_until_ready(fn())
        t0 = time.perf_counter()
        for _ in range(reps):
            out = jax.block_until_ready(fn())
        print(f"{name}: {(time.perf_counter()-t0)/reps*1000:.0f} ms",
              flush=True)
        return out

    # pieces
    nd = len(ph.q_dyn_keys)
    dyn_stack = jnp.asarray(
        np.tile(np.asarray(pk.l0_coeffs), (nd, 1)))
    shift_np, zh_np = PV._subcoset_tables_np(k, ph.ext_k, 0)
    theta = jnp.asarray(FR.encode(3))
    print(f"dyn polys: {nd}, static: {len(ph.q_static_keys)}", flush=True)

    timed(f"dyn coset-NTT stack ({nd} x 2^{k})",
          lambda: ph._ntt_many(dyn_stack, nd, False, jnp.asarray(shift_np))
          if False else
          jax.jit(lambda s, sp: ph._ntt_many(s, nd, False, sp))(
              dyn_stack, jnp.asarray(shift_np)))

    se = ph.static_subcoset_evals(0)
    timed("quotient_subcoset (1 of %d)" % ph.ratio,
          lambda: ph.quotient_subcoset(
              se, dyn_stack, theta, theta, theta, theta,
              jnp.asarray(shift_np), jnp.asarray(zh_np)))

    one_poly = jnp.asarray(np.asarray(pk.l0_coeffs))
    timed("single NTT 2^%d" % k,
          lambda: jax.jit(lambda x: ntt_many(ph.dom, x, 1))(one_poly))

    timed("commit (tabled MSM 2^%d)" % k, lambda: ph.commit(one_poly)[0])

    scal = F.from_mont(FR, one_poly)
    from halo2_aes_tpu.ops import msm as M

    c = M.default_window(srs.n)
    tables = srs._msm_tables
    timed("msm raw", lambda: M.msm((srs.g1_x, srs.g1_y), scal, c=c,
                                   tables=tables)[0])

    # eval_many
    timed(f"eval_many ({nd})",
          lambda: ph.eval_many(dyn_stack, theta, nd))


if __name__ == "__main__":
    main()

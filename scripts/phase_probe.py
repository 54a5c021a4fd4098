"""Micro-profile of the prover's hot device ops on the attached chip.

Times (warm, per call): commit MSM (with tables), batched NTT, batch_inv,
cumprod, a full lookup grand product, and the SHPLONK fold — the inputs
to deciding where the next kernel goes.
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax

from halo2_aes_tpu.utils.cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from halo2_aes_tpu.backend import srs as SRS
from halo2_aes_tpu.ops import field as F
from halo2_aes_tpu.ops import ntt as NTT

FR = F.FR
K = 17
N = 1 << K


def _force(out):
    # a tiny device->host read waits on the whole computation
    leaves = jax.tree_util.tree_leaves(out)
    for leaf in leaves:
        np.asarray(leaf.reshape(-1)[:1])
    return out


def timeit(name, fn, reps=3):
    out = _force(fn())   # warm/compile
    t0 = time.perf_counter()
    for _ in range(reps):
        out = _force(fn())
    dt = (time.perf_counter() - t0) / reps
    print(f"{name:40s} {dt*1e3:9.1f} ms", flush=True)
    return out


def main():
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.integers(0, 1 << 16, (N, F.LIMBS), dtype=np.uint32))
    srs = SRS.setup(K)
    srs.warm_tables()
    dom = NTT.domain(FR, K)

    timeit("commit 2^17 (tables)", lambda: srs.commit(a))
    timeit("mont_mul 2^17", lambda: F.mont_mul(FR, a, a))
    timeit("ntt 2^17 x1", lambda: NTT.ntt(dom, a))
    flat25 = jnp.tile(a, (25, 1))
    timeit("ntt_many 2^17 x25", lambda: NTT.ntt_many(dom, flat25, 25), reps=2)
    timeit("batch_inv 2^17", lambda: F.batch_inv(FR, a))
    timeit("cumprod 2^17", lambda: F.cumprod(FR, a))

    from halo2_aes_tpu.backend import lookup as LK

    blind = jnp.asarray(rng.integers(0, 1 << 16, (5, F.LIMBS), dtype=np.uint32))
    beta = jnp.asarray(FR.encode(12345))
    gamma = jnp.asarray(FR.encode(67890))
    usable = N - 6
    timeit("lookup grand_product 2^17",
           lambda: LK.grand_product(a, a, a, a, usable, beta, gamma, blind))

    from halo2_aes_tpu.backend import permutation as PERM

    m = 7
    perm_vals = jnp.tile(a, (m, 1))
    z_blind = jnp.asarray(rng.integers(0, 1 << 16, (3, 5, F.LIMBS),
                                       dtype=np.uint32))
    omega_pows, delta_pows = PERM._label_tables(K, m)
    rows = jnp.broadcast_to(jnp.arange(1 << K, dtype=jnp.int32), (m, 1 << K))
    cols = jnp.broadcast_to(jnp.arange(m, dtype=jnp.int32)[:, None],
                            (m, 1 << K))
    timeit("perm grand_products m=7 2^17",
           lambda: PERM.grand_products(K, usable, 3, perm_vals,
                                       list(range(m)), cols, rows,
                                       omega_pows, delta_pows,
                                       beta, gamma, z_blind),
           reps=2)


if __name__ == "__main__":
    main()

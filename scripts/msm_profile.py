"""MSM timing breakdown on the real chip.

Times the full tabled commit (the prover's path) and its sub-stages
separately: digit extraction, sort, gather, tree up-sweep, Fenwick
extraction.  Usage: python scripts/msm_profile.py [k] [reps]
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 17
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 3

    import jax

    from halo2_aes_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from halo2_aes_tpu.ops import curve as CV
    from halo2_aes_tpu.ops import msm as M

    n = 1 << k
    rng = np.random.default_rng(0)
    base = CV.affine_from_ints([CV.py_mul((CV.G1_X, CV.G1_Y), i + 1)
                                for i in range(64)])
    px = jnp.tile(base[0], (n // 64, 1))
    py = jnp.tile(base[1], (n // 64, 1))
    limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
    limbs[:, 15] &= 0x1FFF
    scal = jnp.asarray(limbs)
    c = M.default_window(n)
    print(f"k={k} c={c} windows={-(-M.SCALAR_BITS // c)}", flush=True)

    t0 = time.time()
    tables = jax.block_until_ready(M.build_tables((px, py), c))
    print(f"build_tables: {time.time()-t0:.1f}s", flush=True)

    def _sync(out):
        # a tiny device->host transfer waits on the whole computation
        leaves = jax.tree_util.tree_leaves(out)
        for lf in leaves:
            np.asarray(lf[tuple(0 for _ in lf.shape)])
        return out

    def timed(name, fn, *a, **kw):
        out = _sync(fn(*a, **kw))  # compile+run
        t0 = time.time()
        for _ in range(reps):
            out = _sync(fn(*a, **kw))
        print(f"{name}: {(time.time()-t0)/reps*1000:.1f} ms", flush=True)
        return out

    timed("msm_tabled", M.msm, (px, py), scal, c=c, tables=tables)
    timed("msm_untabled", M.msm, (px, py), scal, c=c)

    # --- sub-stage breakdown (mirrors _window_sums internals) ----------
    W = -(-M.SCALAR_BITS // c)
    digs = timed("digits", jax.jit(lambda s: M.digit_matrix(s, c)), scal)
    n_pad = n
    idx_bits = k
    iota = jnp.arange(n_pad, dtype=jnp.uint32)

    @jax.jit
    def sort_all(digs):
        keys = (digs.astype(jnp.uint32) << idx_bits) | iota[None, :]
        return jnp.sort(keys, axis=1)

    keys = timed(f"sort ({W}, 2^{k})", sort_all, digs)

    @jax.jit
    def gather_all(keys, txy):
        order = (keys & jnp.uint32(n_pad - 1)).astype(jnp.int32)
        tbase = (jnp.arange(W, dtype=jnp.int32) * n)[:, None]
        flat_idx = (tbase + order).reshape(-1)
        g = jnp.take(txy, flat_idx, axis=0)
        return g[:, :16], g[:, 16:]

    sx, sy = timed("gather", gather_all, keys, tables)

    one = jnp.asarray(CV.FQ.one_mont)
    sz = jnp.broadcast_to(one, sx.shape)

    @jax.jit
    def upsweep(sx, sy, sz):
        cur = (sx, sy, sz)
        m = sx.shape[0]
        while m > 1 and m % 2 == 0:   # stop at the odd W remainder
            cur = CV.add(tuple(t[0::2] for t in cur),
                         tuple(t[1::2] for t in cur))
            m //= 2
        return cur

    timed(f"upsweep ({W * n} rows)", upsweep, sx, sy, sz)

    # one tree level at full width (the dominant level)
    @jax.jit
    def one_level(sx, sy, sz):
        return CV.add((sx[0::2], sy[0::2], sz[0::2]),
                      (sx[1::2], sy[1::2], sz[1::2]))

    timed(f"level0 ({W * n} rows)", one_level, sx, sy, sz)

    # contiguous-halves fold (bit-reversed tree layout): reshape
    # (G, m, 16) + half slices instead of stride-2 rows
    @jax.jit
    def upsweep_halves(sx, sy, sz):
        cur = (sx, sy, sz)
        m = n
        G = W
        while m > 1:
            half = m // 2

            def _split(t):
                t3 = t.reshape(G, m, 16)
                return (t3[:, :half].reshape(G * half, 16),
                        t3[:, half:].reshape(G * half, 16))

            lo, hi = zip(*(_split(t) for t in cur))
            cur = CV.add(tuple(lo), tuple(hi))
            m = half
        return cur

    timed(f"upsweep_halves ({W * n} rows)", upsweep_halves, sx, sy, sz)

    # raw fused adder at the same width (no strided slicing)
    half = (W * n) // 2
    p1 = (sx[:half], sy[:half], sz[:half])
    p2 = (sx[half:], sy[half:], sz[half:])

    @jax.jit
    def raw_add(p1, p2):
        return CV.add(p1, p2)

    timed(f"raw_add ({half} rows)", raw_add, p1, p2)


if __name__ == "__main__":
    main()

"""Multi-scalar multiplication (Pippenger) on the accelerator.

The commitment engine's core op (role of halo2's best_multiexp,
SURVEY.md section 2.13 item 3: "advice commitments (MSM)").  Instead of
scattering points into buckets, the bucket sums come from a *dyadic
reduction tree over digit-sorted points*, so every step is a sort, a
gather or one large batched add:

  1. per window, sort (digit << idx_bits | index) — one u32 sort,
  2. gather points into sorted order and build a binary reduction tree
     bottom-up: every level is ONE huge batched complete-add over all
     windows at once (one G1-adder kernel launch on the GPU),
  3. for every bucket b, the cumulative prefix C_b = sum of all points
     with digit <= b is assembled Fenwick-style from <= log2(n)+1 tree
     nodes (the dyadic decomposition of the prefix length), again as
     batched adds across all (window, bucket) pairs,
  4. the window sum telescopes with NO per-bucket suffix scan:
         sum_b b * (C_b - C_{b-1}) = (B-1) * C_{B-1} - sum_{b<B-1} C_b
     where C_{B-1} is the tree root, so one (2^c - 1)-scalar-mul and one
     log-depth fold finish the window,
  5. Horner across windows: acc = 2^c * acc + S_w.

Work: ~n tree adds + B(log n + 2) extraction adds per window, vs 2n+2B
for the segmented-scan formulation — and every add sits in a maximal
batch, so each kernel launch is wide.

Windows are processed in memory-bounded groups via ``lax.map`` (the
tree materializes ~3x the gathered points per window in device memory).

Scalars are PLAIN (non-Montgomery) Fr limb vectors; points are affine
Montgomery Fq limb pairs (no identities — SRS points never are).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from halo2_aes_tpu.ops import curve as CV
from halo2_aes_tpu.ops import field as F

SCALAR_BITS = 254

# max gathered-tree rows (G * n_pad) per window group: the rank-2 tree
# holds ~2*rows per level chain * 3 coords * 64 B/row (~0.4 GB/2^20
# rows), and the k=20 prover phases keep much of device memory occupied
# already.  At n <= 2^17 the whole window set fits one group, and fewer
# sequential lax.map groups cut the latency-bound tail.
_GROUP_BUDGET = 1 << 20


def _group_budget(n_pad: int = 1 << 20) -> int:
    return (1 << 23) if n_pad <= (1 << 17) else _GROUP_BUDGET


def default_window(n: int) -> int:
    """Window size minimizing W*(n + B*(log2 n + 2)) tree+extract adds."""
    lg = max(1, int(np.ceil(np.log2(max(n, 2)))))
    best, best_cost = 8, None
    for c in range(6, 17):
        if c + lg > 32:  # digit and index must pack into one u32 key
            continue
        w = -(-SCALAR_BITS // c)
        cost = w * (n + (1 << c) * (lg + 2))
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    return best


def digit_matrix(scalars, c: int):
    """(n, 16) plain limbs -> (windows, n) int32 window digits, LSB first."""
    windows = -(-SCALAR_BITS // c)
    mask = jnp.uint32((1 << c) - 1)
    rows = []
    for w in range(windows):
        start = w * c
        l, off = divmod(start, F.LIMB_BITS)
        v = scalars[..., l] >> off
        got = F.LIMB_BITS - off
        while got < c and l + 1 < F.LIMBS:
            l += 1
            v = v | (scalars[..., l] << got)
            got += F.LIMB_BITS
        rows.append((v & mask).astype(jnp.int32))
    return jnp.stack(rows)


def _tree_add(pts):
    """Fold a stacked point array (m, ..., LIMBS) down axis 0 with the
    complete adder: log2(m) sequential levels (contiguous halves: a
    stride-2 row slice of a (rows, 16) u32 tensor is a strided copy,
    a contiguous half is a plain slice)."""
    x, y, z = pts
    m = x.shape[0]
    while m > 1:
        half = m // 2
        lo = (x[:half], y[:half], z[:half])
        hi = (x[half : 2 * half], y[half : 2 * half], z[half : 2 * half])
        s = CV.add(lo, hi)
        x = jnp.concatenate([s[0], x[2 * half :]], axis=0)
        y = jnp.concatenate([s[1], y[2 * half :]], axis=0)
        z = jnp.concatenate([s[2], z[2 * half :]], axis=0)
        m = x.shape[0]
    return (x[0], y[0], z[0])


def _bitrev_cols(x, w: int):
    """Bit-reverse the low ``w`` bits of a u32/int array (values < 2^w)."""
    if w == 0:
        return jnp.zeros_like(x)
    x = x.astype(jnp.uint32)
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    x = (x << 16) | (x >> 16)
    return (x >> (32 - w)).astype(jnp.int32)


@functools.lru_cache(maxsize=None)
def _bitrev_perm_np(lg: int) -> np.ndarray:
    n = 1 << lg
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(lg):
        rev |= ((idx >> b) & 1) << (lg - 1 - b)
    return rev.astype(np.int32)


def _double_n(p, times: int):
    """times sequential doublings as a fori_loop (one doubler in the
    trace regardless of times, which keeps compiles small)."""
    return jax.lax.fori_loop(0, times, lambda _, q: CV.double(q), p)


def _window_sums(px, py, digs, c: int, n_real: int, tables=None,
                 tbase=None):
    """Per-window bucket-weighted sums.

    px/py: (n_pad, 16) affine Montgomery points (pow-2 padded), shared
    by every window — OR ``tables``: ONE interleaved (W*n, 32) array of
    per-window affine rows (the 2^{cw}-shifted SRS tables) with
    ``tbase`` (G,) window indices, in which case px/py are ignored and
    the caller skips the Horner fold entirely.
    digs:  (G, n_pad) int32 digits for a group of G windows
           (padding rows carry digit 0 and are masked to identity).
    Returns (x, y, z) each (G, 16): S_w = sum_b b * bucket_b.

    Every limb tensor stays RANK-2 (rows, 16), with windows as row
    segments, so one flat batched add covers every window.  Windows live as contiguous row segments of the flat tensors; every
    segment length is a power of two, so the half-split folds of the
    up-sweep never pair rows across a window boundary.
    """
    G, n_pad = digs.shape
    lg = n_pad.bit_length() - 1
    assert 1 << lg == n_pad
    idx_bits = lg
    assert c + idx_bits <= 32
    buckets = 1 << c
    one = jnp.asarray(CV.FQ.one_mont)

    iota = jnp.arange(n_pad, dtype=jnp.uint32)
    keys = (digs.astype(jnp.uint32) << idx_bits) | iota[None, :]
    keys = jnp.sort(keys, axis=1)
    ds = (keys >> idx_bits).astype(jnp.int32)            # sorted digits
    order = (keys & jnp.uint32(n_pad - 1)).astype(jnp.int32)

    # leaves live in BIT-REVERSED sorted position: the up-sweep then
    # pairs contiguous halves instead of stride-2 rows, and the Fenwick
    # extraction bit-reverses its node indices to match.
    br = jnp.asarray(_bitrev_perm_np(lg))
    order_br = jnp.take(order, br, axis=1)

    if tables is None:
        pxy = jnp.concatenate([px, py], axis=1)          # (n_pad, 32)
        flat_idx = order_br.reshape(-1)                  # (G*n_pad,)
        sxy = jnp.take(pxy, flat_idx, axis=0)            # (G*n_pad, 32)
    else:
        # WINDOW-LOCAL takes: each step gathers from its own (n, 32)
        # table slice rather than one flat take spanning the whole
        # multi-hundred-MB table (locality)
        t3 = tables.reshape(-1, n_pad, 2 * F.LIMBS)      # (W, n, 32)

        def _gather_one(args):
            w, o = args
            tw = jax.lax.dynamic_index_in_dim(t3, w, axis=0,
                                              keepdims=False)
            return jnp.take(tw, o, axis=0)

        sxy = jax.lax.map(_gather_one, (tbase, order_br))
        sxy = sxy.reshape(G * n_pad, 2 * F.LIMBS)
    sx = sxy[:, :F.LIMBS]
    sy = sxy[:, F.LIMBS:]
    # padding -> the identity class (0 : y!=0 : 0): the homogeneous
    # complete adder needs X masked to 0 and Y nonzero, Z = 0.
    live = (order_br < n_real).reshape(-1, 1)
    sx = jnp.where(live, sx, jnp.uint32(0))
    sy = jnp.where(live, sy, one)
    sz = jnp.where(live, one, jnp.uint32(0))

    def _halves_fold_once(cur, m):
        # adds row j to row j+m/2 inside every window segment; with
        # bit-reversed leaves this IS the adjacent-pair interval tree
        half = m // 2

        def _split(t):
            t3 = t.reshape(G, m, F.LIMBS)
            return (t3[:, :half].reshape(G * half, F.LIMBS),
                    t3[:, half:].reshape(G * half, F.LIMBS))

        lo, hi = zip(*(_split(t) for t in cur))
        return CV.add(tuple(lo), tuple(hi))

    # ---- up-sweep: dyadic interval tree over the sorted order ------------
    # levels[l] rows are nodes in bit-reversed (lg-l)-bit index order
    levels = [(sx, sy, sz)]                              # lvl: (G*(n_pad>>lvl), 16)
    cur = (sx, sy, sz)
    m = n_pad
    while m > 1:
        cur = _halves_fold_once(cur, m)
        m //= 2
        levels.append(cur)
    root = cur                                           # (G, 16)

    # ---- Fenwick extraction of C_b = prefix sum of first m_b elements ----
    bvals = jnp.arange(buckets, dtype=jnp.int32)
    mcounts = jax.vmap(
        lambda row: jnp.searchsorted(row, bvals, side="right")
    )(ds).astype(jnp.int32)                              # (G, B) in [0, n]

    gofs = jnp.arange(G, dtype=jnp.int32)[:, None]
    acc = CV.identity((G * buckets,))
    for lvl in range(len(levels)):
        m_lvl = n_pad >> lvl
        bit = (((mcounts >> lvl) & 1) == 1).reshape(-1)  # (G*B,)
        idx = (mcounts >> (lvl + 1)) << 1
        idx = jnp.clip(idx, 0, m_lvl - 1)
        idx = _bitrev_cols(idx, lg - lvl)                # physical row
        flat = (gofs * m_lvl + idx).reshape(-1)          # rows of levels[lvl]
        gathered = tuple(jnp.take(t, flat, axis=0) for t in levels[lvl])
        node = tuple(
            F.select(bit, g, jnp.broadcast_to(i, g.shape))
            for g, i in zip(gathered, CV.identity())
        )
        acc = CV.add(acc, node)

    # ---- telescoped window sum -------------------------------------------
    # sum_b b*D_b = (B-1)*C_{B-1} - sum_{b=0}^{B-2} C_b ; C_{B-1} = root
    last = (jnp.arange(G * buckets) % buckets) == buckets - 1
    cur = tuple(
        F.select(last, jnp.broadcast_to(i, a.shape), a)
        for a, i in zip(acc, CV.identity())
    )
    m = buckets
    while m > 1:                                         # (G*B, 16) -> (G, 16)
        cur = _halves_fold_once(cur, m)
        m //= 2
    sum_rest = cur
    scaled = CV.add(_double_n(root, c), CV.neg(root))    # (2^c - 1) * root
    return CV.add(scaled, CV.neg(sum_rest))


@functools.partial(jax.jit, static_argnames=("c",))
def _double_c(p, c: int):
    return jax.lax.fori_loop(0, c, lambda _i, q: CV.double(q), p)


@jax.jit
def _tables_normalize(sx, sy, sz):
    zinv = F.batch_inv(CV.FQ, sz)
    ax = F.mul(CV.FQ, sx, zinv)
    ay = F.mul(CV.FQ, sy, zinv)
    return ax, ay


def build_tables(points, c: int):
    """Affine window tables T[w][i] = 2^{cw} * P_i as ONE interleaved
    (W*n, 32) array (x limbs in lanes [0,16), y in [16,32); window w's
    points at rows [w*n, (w+1)*n)) — one 32-lane row gather fetches
    both coordinates (measured ~1.3x the two-take variant).

    One-time per SRS (role of a Pippenger precomputation): with these,
    ``msm`` needs NO Horner doubling chain — every window's sum is
    already scaled, so the final fold is a log-depth point sum.
    Cost: (W-1)*c batched doublings + one batched inversion.

    Deliberately NOT one jitted program: each window is doubled,
    normalized and staged to the host in turn, so device memory holds
    one window's temps at a time."""
    px, py = points
    one = jnp.broadcast_to(jnp.asarray(CV.FQ.one_mont), px.shape)
    W = -(-SCALAR_BITS // c)
    cur = (px, py, one)
    # normalize PER WINDOW: one whole-table batch_inv lets XLA pick
    # padded layouts for its scan temps; per-window the temps are
    # bounded by ~n rows.  Each window's rows are staged to HOST as
    # built: holding all W windows on device (plus the final
    # concatenate's copy) peaks at ~2x the table size — the result is
    # disk-cached anyway, and the caller uploads the finished table once.
    rows = np.empty((W * px.shape[0], 2 * F.LIMBS), dtype=np.uint32)
    n = px.shape[0]
    for w in range(W):
        if w:
            cur = _double_c(cur, c)
        ax, ay = _tables_normalize(*cur)
        rows[w * n : (w + 1) * n, : F.LIMBS] = np.asarray(ax)
        rows[w * n : (w + 1) * n, F.LIMBS :] = np.asarray(ay)
    return rows                                        # (W*n, 32) np



@functools.partial(jax.jit, static_argnames=("c",))
def msm(points, scalars, c: int | None = None, tables=None):
    """sum_i scalars[i] * points[i].

    points:  (x, y) affine Montgomery limb arrays, each (n, 16).
    scalars: (n, 16) PLAIN Fr limb array.
    tables:  optional ``build_tables`` output ((W*n, 32) interleaved
             affine rows; n must be a power of two): windows are
             pre-scaled by 2^{cw}, so the sequential Horner doubling
             chain (the latency tail of the table-less path)
             disappears.
    Returns a projective point (3 x (16,) limbs, Montgomery).

    Jitted at this boundary: compiled once per (n, c) and reused across
    every commitment of a proof.
    """
    px, py = points
    n = px.shape[0]
    if c is None:
        c = default_window(n)
    n_pad = max(2, 1 << (n - 1).bit_length())
    if n_pad != n:
        assert tables is None, "tables require power-of-two n"
        pad = ((0, n_pad - n), (0, 0))
        px = jnp.pad(px, pad)
        py = jnp.pad(py, pad)

    digs = digit_matrix(scalars, c)                      # (W, n), LSB first
    W = digs.shape[0]
    if tables is not None:
        assert tables.shape == (W * n, 2 * F.LIMBS)
    if n_pad != n:
        digs = jnp.pad(digs, ((0, 0), (0, n_pad - n)))

    group = max(1, min(W, _group_budget(n_pad) // n_pad))
    n_groups = -(-W // group)
    group = -(-W // n_groups)   # balance: 26 windows as 4x7, not 3x8+2
    if n_groups * group != W:  # pad with all-zero-digit windows (S_w = 0)
        digs = jnp.pad(digs, ((0, n_groups * group - W), (0, 0)))
    digs = digs.reshape(n_groups, group, n_pad)

    if tables is not None:
        # per-group window INDICES into the (W, n, 32) tables; padding
        # windows have all-zero digits (S_w = 0 for ANY points) — clip
        wbase = jnp.clip(jnp.arange(n_groups * group, dtype=jnp.int32),
                         0, W - 1)
        wbase = wbase.reshape(n_groups, group)
        sums = jax.lax.map(
            lambda args: _window_sums(px, py, args[0], c, n,
                                      tables=tables, tbase=args[1]),
            (digs, wbase),
        )
        # windows are pre-scaled: the MSM is the plain sum of all sums
        return _tree_add(tuple(t.reshape(-1, F.LIMBS) for t in sums))

    sums = jax.lax.map(
        lambda d: _window_sums(px, py, d, c, n), digs
    )                                                    # (n_groups, G, 16) x3
    sx, sy, sz = (t.reshape(n_groups * group, F.LIMBS) for t in sums)

    # Horner fold, MSB window first
    def fold(i, acc):
        w = W - 1 - i
        acc = _double_n(acc, c)
        return CV.add(acc, (sx[w], sy[w], sz[w]))

    return jax.lax.fori_loop(0, W, fold, CV.identity())


@functools.partial(jax.jit, static_argnames=("c", "count"))
def msm_many(points, scalars_flat, count: int, c: int, tables):
    """``count`` independent MSMs over the SAME point set in ONE
    executable: scalars_flat is FLAT (count*n, 16) plain Fr limbs
    (commitment i's scalars at rows [i*n, (i+1)*n)).

    The prover issues ~27 size-n commitments per proof; dispatched one
    jitted call each they execute as ~27 sequential launch chains whose
    small tail levels are latency-bound.  Batching staples every
    commitment's windows onto the same group axis, so the device sees
    one long stream of maximal-batch adds instead of 27 short ones.

    Requires the 2^{cw}-shifted window ``tables`` (no Horner tail) and
    power-of-two n.  Returns a projective (3, count, 16) stack."""
    px, py = points
    n = px.shape[0]
    assert n & (n - 1) == 0, "tables require power-of-two n"
    W = -(-SCALAR_BITS // c)
    assert tables.shape == (W * n, 2 * F.LIMBS)

    digs = jnp.concatenate(
        [digit_matrix(scalars_flat[i * n : (i + 1) * n], c)
         for i in range(count)])                          # (count*W, n)
    total = count * W
    group = max(1, min(total, _group_budget(n) // n))
    n_groups = -(-total // group)
    group = -(-total // n_groups)
    if n_groups * group != total:
        digs = jnp.pad(digs, ((0, n_groups * group - total), (0, 0)))
    wbase = jnp.clip(jnp.arange(n_groups * group, dtype=jnp.int32) % W,
                     0, W - 1)
    sums = jax.lax.map(
        lambda args: _window_sums(px, py, args[0], c, n,
                                  tables=tables, tbase=args[1]),
        (digs.reshape(n_groups, group, n), wbase.reshape(n_groups, group)),
    )
    # (n_groups, G, 16) x3 -> per-commit window stacks -> tree fold
    out = []
    for t in sums:
        flat = t.reshape(n_groups * group, F.LIMBS)[:total]
        out.append(jnp.swapaxes(flat.reshape(count, W, F.LIMBS), 0, 1)
                   .reshape(W * count, F.LIMBS))
    # fold the W axis: rows [w*count, (w+1)*count) hold window w for all
    # commits; _tree_add needs window-major halving, so reshape to
    # (W, count, 16) folding semantics via the flat row layout
    x, y, z = out
    m = W
    while m > 1:
        half = m // 2
        lo = (x[: half * count], y[: half * count], z[: half * count])
        hi = (x[half * count : 2 * half * count],
              y[half * count : 2 * half * count],
              z[half * count : 2 * half * count])
        s = CV.add(lo, hi)
        x = jnp.concatenate([s[0], x[2 * half * count :]], axis=0)
        y = jnp.concatenate([s[1], y[2 * half * count :]], axis=0)
        z = jnp.concatenate([s[2], z[2 * half * count :]], axis=0)
        m -= half
    return jnp.stack([x, y, z])


def msm_host(points, scalars) -> tuple | None:
    """Host oracle: python-int Pippenger-free reference (for tests)."""
    acc = None
    for p, s in zip(points, scalars):
        acc = CV.py_add(acc, CV.py_mul(p, int(s)))
    return acc

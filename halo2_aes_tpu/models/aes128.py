"""The fixed-key multi-block AES-128 circuit, compiled to a static layout.

Batched-JAX counterpart of ``FixedAes128Config<K, N>`` (reference
src/aes128.rs): same constraint structure — 4 shared table columns, N sets
of 3 advice columns with 5 lookup arguments each, a dedicated key-schedule
words column + rcon fixed column + one custom gate, ShiftRows as pure
copy rewiring (zero rows), 1360 rows per block — but the whole layout is
computed up front as index maps (one 1360-row block template replicated
with offsets), so witness generation is a batched gather instead of
4 million Layouter region calls.

Deliberate deviations from the reference (see SURVEY.md section 7):
  * capacity accounts for blinding rows (reference src/aes128.rs:303-325
    checks against 2^K exactly and panics; we raise CapacityError),
  * the key schedule consumes exactly 400 chip rows (reference budgets
    1760, src/constant.rs:113),
  * optional ``expose_ciphertext`` instance column (reference TODO at
    src/aes128.rs:174),
  * provably-dead lookup arguments are pruned at compile time (the
    reference pays for 5 lookups per column set even when a chip never
    fires, e.g. the range chip outside the key-schedule set,
    src/aes128.rs:63-115,168) — see circuit/ir.py prune_dead_lookups.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

import numpy as np

from halo2_aes_tpu.circuit.ir import (
    ADVICE,
    CompiledCircuit,
    ConstraintSystem,
    Prod,
    Ref,
    Sum,
    Neg,
)
from halo2_aes_tpu.models import constants as C
from halo2_aes_tpu.models import key_schedule as KS
from halo2_aes_tpu.models import table as T
from halo2_aes_tpu.models.chips import (
    ChipSet,
    DEC_SELECTOR_NAMES,
    DecChipSet,
    SELECTOR_NAMES,
    configure_chip_set,
    configure_dec_chip_set,
)

BLOCK_ROWS = C.AES_BLOCK_ROWS  # 1360


class CapacityError(ValueError):
    """Too many AES blocks for the domain (reference panics here,
    src/aes128.rs:161)."""


@dataclass(frozen=True)
class AesConfig:
    k: int = 17
    n_sets: int = 1            # N advice-column sets ("horizontal" scaling)
    n_blocks: int = 1          # encryptions per proof
    expose_ciphertext: bool = False
    tagged_ops: bool = False   # LEAN mode: fuse sbox/mul2/mul3 into ONE
    #   tagged lookup per set (3 lookup arguments instead of the
    #   reference's 5, src/aes128.rs:63-115) — same rows, same table,
    #   one extra fixed tag column per set.  Fewer lookups = 3 fewer
    #   commitments/NTTs/grand-products per set per proof and ~0.5 GB
    #   less device memory per set at k=20; the proof shrinks by 96
    #   bytes/set.
    #   Default OFF: the 5-lookup shape is the byte-for-byte reference
    #   parity configuration.


# --------------------------------------------------------------------------
# block template (set-local row/pool indices; pool index == row index)
# --------------------------------------------------------------------------

_KSREF_BASE = -2


def _ksref(ks_idx: int) -> int:
    return _KSREF_BASE - ks_idx


@dataclass
class BlockTemplate:
    a_pool: np.ndarray = dfield(
        default_factory=lambda: np.full((3, BLOCK_ROWS), -1, np.int32)
    )
    sel: dict = dfield(default_factory=dict)
    intra_pairs: list = dfield(default_factory=list)   # (ck_a,row_a,ck_b,row_b)
    rk_pairs: list = dfield(default_factory=list)      # (ck_a,row_a,r,j): a-cell <- rk byte


def build_block_template() -> BlockTemplate:
    t = BlockTemplate()
    for name in SELECTOR_NAMES:
        t.sel[name] = np.zeros(BLOCK_ROWS, bool)
    SHIFT = C.SHIFT_ROWS_IDX
    M = C.MIX_MATRIX

    # plaintext rows (fresh witness; reference src/aes128.rs:176-192)
    t.a_pool[0, 0:16] = np.arange(16)

    # initial AddRoundKey
    for i in range(16):
        row = 16 + i
        t.a_pool[0, row] = i
        t.a_pool[1, row] = _ksref(KS.rk_pool_idx(0, i))
        t.a_pool[2, row] = row
        t.sel["q_u8_xor"][row] = True
        t.intra_pairs.append((0, row, 0, i))
        t.rk_pairs.append((1, row, 0, i))

    for r in range(1, 11):
        br = 32 + (r - 1) * 144 if r < 10 else 1328
        # SubBytes
        for i in range(16):
            row = br + i
            t.a_pool[0, row] = br - 16 + i
            t.a_pool[1, row] = row
            t.sel["q_sbox"][row] = True
            t.intra_pairs.append((0, row, 2, br - 16 + i))

        if r < 10:
            # MixColumns via lcon: 7 rows per output byte
            out_cells = {}
            for i in range(4):
                for m in range(4):
                    lb = br + 16 + (4 * i + m) * 7
                    tmp_cells = []
                    for j in range(4):
                        row = lb + j
                        src_row = br + int(SHIFT[4 * i + j])  # shifted byte
                        coeff = int(M[m][j])
                        if coeff == 1:
                            t.a_pool[0, row] = row
                            tmp_cells.append((0, row))
                        else:
                            t.a_pool[0, row] = src_row
                            t.a_pool[1, row] = row
                            t.sel["q_mul_by_2" if coeff == 2 else "q_mul_by_3"][row] = True
                            tmp_cells.append((1, row))
                        t.intra_pairs.append((0, row, 1, src_row))
                    for g, (xa, xb) in enumerate([(0, 1), (2, 3)]):
                        row = lb + 4 + g
                        t.a_pool[0, row] = lb + xa
                        t.a_pool[1, row] = lb + xb
                        t.a_pool[2, row] = row
                        t.sel["q_u8_xor"][row] = True
                        t.intra_pairs.append((0, row, *tmp_cells[xa]))
                        t.intra_pairs.append((1, row, *tmp_cells[xb]))
                    row = lb + 6
                    t.a_pool[0, row] = lb + 4
                    t.a_pool[1, row] = lb + 5
                    t.a_pool[2, row] = row
                    t.sel["q_u8_xor"][row] = True
                    t.intra_pairs.append((0, row, 2, lb + 4))
                    t.intra_pairs.append((1, row, 2, lb + 5))
                    out_cells[(i, m)] = (2, row)

        # AddRoundKey
        ark_base = br + 128 if r < 10 else 1344
        for q in range(16):
            row = ark_base + q
            if r < 10:
                i, m = q // 4, q % 4
                t.a_pool[0, row] = br + 16 + q * 7 + 6
                t.intra_pairs.append((0, row, *out_cells[(i, m)]))
            else:
                src_row = br + int(SHIFT[q])
                t.a_pool[0, row] = src_row
                t.intra_pairs.append((0, row, 1, src_row))
            t.a_pool[1, row] = _ksref(KS.rk_pool_idx(r, q))
            t.a_pool[2, row] = row
            t.sel["q_u8_xor"][row] = True
            t.rk_pairs.append((1, row, r, q))
    return t


# --------------------------------------------------------------------------
# full circuit assembly
# --------------------------------------------------------------------------


@dataclass
class AesColumns:
    tables: tuple
    chip_sets: list
    q_eq_rcon: int
    rcon_fixed: int
    words: int
    instance: int | None


def configure(cfg: AesConfig):
    """Build the constraint system (role of reference src/aes128.rs:46-141)."""
    cs = ConstraintSystem()
    tables = tuple(cs.fixed_column(f"table_{n}") for n in ("tag", "in1", "in2", "out"))
    sel_names = DEC_SELECTOR_NAMES if cfg.tagged_ops else SELECTOR_NAMES
    sel_ids = []
    tag_ids = []
    for s in range(cfg.n_sets):
        sel_ids.append(tuple(cs.fixed_column(f"{n}_{s}") for n in sel_names))
        if cfg.tagged_ops:
            tag_ids.append(cs.fixed_column(f"op_tag_{s}"))
    q_eq_rcon = cs.fixed_column("q_eq_rcon")
    rcon_fixed = cs.fixed_column("rcon")

    chip_sets = []
    for s in range(cfg.n_sets):
        advice = tuple(cs.advice_column(f"a{j}_set{s}") for j in range(3))
        if cfg.tagged_ops:
            chip_sets.append(DecChipSet(s, advice, sel_ids[s], tag_ids[s]))
        else:
            chip_sets.append(ChipSet(s, advice, sel_ids[s]))
    words = cs.advice_column("words")

    for chip in chip_sets:
        if cfg.tagged_ops:
            configure_dec_chip_set(cs, chip, tables, label="set")
        else:
            configure_chip_set(cs, chip, tables)

    # the circuit's only custom gate (reference src/key_schedule.rs:59-64)
    cs.create_gate(
        "Equality RC", Prod(Ref(q_eq_rcon), Sum(Ref(words), Neg(Ref(rcon_fixed))))
    )

    for chip in chip_sets:
        for a in chip.advice:
            cs.enable_equality(a)
    cs.enable_equality(words)
    cs.enable_equality(rcon_fixed)  # constants column (enable_constant)

    instance = None
    if cfg.expose_ciphertext:
        instance = cs.instance_column("ciphertext")
        cs.enable_equality(instance)

    return cs, AesColumns(tables, chip_sets, q_eq_rcon, rcon_fixed, words, instance)


def capacities(cfg: AesConfig, cs: ConstraintSystem):
    usable = (1 << cfg.k) - (cs.blinding_factors() + 1)
    c0 = max(0, (usable - KS.CHIP_ROWS) // BLOCK_ROWS)
    cs_rest = usable // BLOCK_ROWS
    return [c0] + [cs_rest] * (cfg.n_sets - 1)


def _fill_selectors(fixed, chip, sel_masks, base, rows, tagged: bool):
    """Write one region's selector masks into the fixed columns.

    Reference mode: one selector column per op (SELECTOR_NAMES order).
    Tagged mode (AesConfig.tagged_ops): sbox/mul2/mul3 collapse into the
    shared q_op selector plus the per-set op_tag value column."""
    def m(name):
        v = sel_masks.get(name)
        if v is None:
            return np.zeros(rows, np.uint32)
        return v[:rows].astype(np.uint32)

    sl = slice(base, base + rows)
    if not tagged:
        for name, col in zip(SELECTOR_NAMES, chip.selectors):
            fixed[col, sl] |= m(name)
        return
    q_range, q_xor, q_op = chip.selectors
    fixed[q_range, sl] |= m("q_u8_range_check")
    fixed[q_xor, sl] |= m("q_u8_xor")
    ms, m2, m3 = m("q_sbox"), m("q_mul_by_2"), m("q_mul_by_3")
    fixed[q_op, sl] |= ms | m2 | m3
    fixed[chip.op_tag, sl] += (int(T.Tag.SBOX) * ms
                               + int(T.Tag.GFMUL2) * m2
                               + int(T.Tag.GFMUL3) * m3)


def compile_circuit(cfg: AesConfig) -> CompiledCircuit:
    cs, cols = configure(cfg)
    n = 1 << cfg.k
    if n < C.TABLE_ROWS:
        raise CapacityError(f"k={cfg.k} too small for the {C.TABLE_ROWS}-row table")
    caps = capacities(cfg, cs)
    if cfg.n_blocks > sum(caps):
        raise CapacityError(
            f"{cfg.n_blocks} blocks > capacity {sum(caps)} at k={cfg.k}, N={cfg.n_sets}"
        )

    num_cols = len(cs.columns)
    fixed = np.zeros((num_cols, n), dtype=np.uint32)
    witness_map = np.full((num_cols, n), -1, dtype=np.int32)

    # table columns
    fixed[list(cols.tables), :] = T.build_table(n)

    # --- key schedule on set 0 + words column --------------------------------
    kst = KS.build_template()
    set0 = cols.chip_sets[0]
    _fill_selectors(fixed, set0, kst.sel, 0, KS.CHIP_ROWS, cfg.tagged_ops)
    fixed[cols.q_eq_rcon, : KS.WORDS_ROWS] = kst.q_eq_rcon.astype(np.uint32)
    fixed[cols.rcon_fixed, : KS.WORDS_ROWS] = kst.rcon_fixed
    witness_map[list(set0.advice), : KS.CHIP_ROWS] = kst.a_pool
    witness_map[cols.words, : KS.WORDS_ROWS] = kst.words_pool

    def ks_cell_to_global(ck, row):
        if ck <= 2:
            return (set0.advice[ck], row)
        if ck == 3:
            return (cols.words, row)
        return (cols.rcon_fixed, row)

    pairs = [
        np.array(
            [(*ks_cell_to_global(a, ra), *ks_cell_to_global(b, rb))
             for (a, ra, b, rb) in kst.pairs],
            dtype=np.int32,
        ).reshape(-1, 4)
    ]

    # --- blocks ---------------------------------------------------------------
    bt = build_block_template()
    tpool = bt.a_pool
    intra = np.array(bt.intra_pairs, dtype=np.int32)
    rk = bt.rk_pairs
    rk_local = np.array([(ck, row) for ck, row, _, _ in rk], dtype=np.int32)
    rk_target = np.array(
        [ks_cell_to_global(*KS.rk_cell(r, j)) for _, _, r, j in rk], dtype=np.int32
    )

    # block -> (set, slot)
    placements = []
    cap_iter = list(enumerate(caps))
    b = 0
    for s, cap in cap_iter:
        for j in range(cap):
            if b >= cfg.n_blocks:
                break
            placements.append((s, j))
            b += 1
    assert len(placements) == cfg.n_blocks

    ks_pool_len = 16 + 10 * 32
    block_starts = np.empty(cfg.n_blocks, dtype=np.int64)

    # resolve template pool codes once
    is_none = tpool == -1
    is_ksref = tpool <= _KSREF_BASE
    ks_idx = (_KSREF_BASE - tpool).astype(np.int32)
    local_idx = tpool

    sel_masks = {name: bt.sel[name] for name in SELECTOR_NAMES}

    for b, (s, j) in enumerate(placements):
        base = (KS.CHIP_ROWS if s == 0 else 0) + j * BLOCK_ROWS
        block_starts[b] = base
        chip = cols.chip_sets[s]
        gpool = ks_pool_len + b * BLOCK_ROWS
        wm = np.where(
            is_none, -1, np.where(is_ksref, ks_idx, local_idx + gpool)
        ).astype(np.int32)
        witness_map[list(chip.advice), base : base + BLOCK_ROWS] = wm
        _fill_selectors(fixed, chip, sel_masks, base, BLOCK_ROWS,
                        cfg.tagged_ops)
        # copy pairs
        adv = np.array(chip.advice, dtype=np.int32)
        ip = np.empty_like(intra)
        ip[:, 0] = adv[intra[:, 0]]
        ip[:, 1] = intra[:, 1] + base
        ip[:, 2] = adv[intra[:, 2]]
        ip[:, 3] = intra[:, 3] + base
        rp = np.empty((len(rk), 4), dtype=np.int32)
        rp[:, 0] = adv[rk_local[:, 0]]
        rp[:, 1] = rk_local[:, 1] + base
        rp[:, 2:] = rk_target
        pairs += [ip, rp]

    # --- public-input exposure (reference TODO at src/aes128.rs:174) --------
    if cfg.expose_ciphertext:
        inst = cols.instance
        ct_pairs = np.empty((cfg.n_blocks * 16, 4), dtype=np.int32)
        for b, (s, j) in enumerate(placements):
            base = (KS.CHIP_ROWS if s == 0 else 0) + j * BLOCK_ROWS
            gpool = ks_pool_len + b * BLOCK_ROWS
            a2 = cols.chip_sets[s].advice[2]
            for q in range(16):
                row = 16 * b + q
                # instance value = ciphertext byte (round-10 ARK output)
                witness_map[inst, row] = gpool + 1344 + q
                ct_pairs[16 * b + q] = (inst, row, a2, base + 1344 + q)
        pairs.append(ct_pairs)

    copy_pairs = np.concatenate(pairs, axis=0)

    # drop lookups whose guard selector never fires (e.g. the u8 range
    # lookup of every set but the key schedule's, or all five lookups of
    # a set that received no blocks) — the reference configures them
    # unconditionally and pays for them in every proof
    from halo2_aes_tpu.circuit.ir import prune_dead_lookups

    pruned = prune_dead_lookups(cs, fixed)

    meta = {
        "pruned_lookups": pruned,
        "config": cfg,
        "columns": cols,
        "capacities": caps,
        "block_starts": block_starts,
        "ks_pool_len": ks_pool_len,
        "placements": placements,
    }
    return CompiledCircuit(
        k=cfg.k,
        cs=cs,
        fixed=fixed,
        witness_map=witness_map,
        copy_pairs=copy_pairs,
        pool_len=ks_pool_len + cfg.n_blocks * BLOCK_ROWS,
        meta=meta,
    )

"""Batched FM-index device kernels (JAX).

Implements the anchoring stage of the pipeline — the equivalents of
``bwt_occ``/``bwt_2occ`` (lib/bwa/bwt.c:107-163), ``bwt_sa``
(lib/bwa/bwt.c:86-96) and the active seeder ``getLocs_extend_whole_step``
(src/BWT.cpp:312-394) — as fixed-shape, batched computations:

- ``occ``          : vectorized rank via checkpoint + in-block popcount
                     (VPU-friendly: 8 uint32 words per 128-base block),
- ``sa_lookup``    : lockstep inverse-Psi walk (<= sa_intv steps) over all
                     hit lanes at once,
- ``seed_anchors`` : the full seeding stage for a read batch.

Device redesign of the anchor search: the reference grows each anchor
to its maximal length by re-running the whole backward search per added
base (src/BWT.cpp:333-342 — O(m^2) rank queries per anchor).  Because the
indexed text is fwd+revcomp (bntseq.c:301-307), occurrences of a pattern P
and of revcomp(P) are mirror images: P at position x <-> revcomp(P) at
2*l_pac - x - len(P).  We therefore search for revcomp(anchor): growing
the anchor on the *right* then prepends one complemented base on the
*left* of the searched pattern — a single incremental backward-extension
step (O(m) total rank queries), in lockstep across all (read, sample
position) lanes.  The located hits are mapped back through the mirror, so
the emitted seed set (tPos, qPos, len, strand) is exactly the reference's.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


# Maximum anchor length; the reference stores seed length in a 12-bit
# field (Seed_t.len, src/LordFAST.h:30-35), so 4095 is its hard cap too.
MAX_ANCHOR_LEN = 4095


def _row_gather(stripe, rows, axis):
    """Row gather from an index array, local or interval-routed.

    axis=None: ``stripe`` is the full (replicated) array — plain gather.
    axis=<mesh axis name>: ``stripe`` is this device's row stripe of the
    array (shard_map local view; global row r lives on shard r // rps at
    local row r % rps) — rows are routed to their owners
    (_row_gather_routed), falling back to the all-gather pattern
    (_row_gather_ag) when the owner distribution is too skewed.
    """
    if axis is None:
        return stripe[rows]
    return _row_gather_routed(stripe, rows, axis)


def _row_gather_ag(stripe, rows, axis):
    """All-gather routing (the original pattern): gather every device's
    query rows, every shard answers the subset it owns (zeros
    elsewhere), and a reduce-scatter returns each device its answers.
    Simple and skew-proof, but the value reduce-scatter moves ~(D-1) x
    the answer bytes — the routed path below is the cheap common case.
    """
    rps = stripe.shape[0]
    d = jax.lax.axis_index(axis)
    all_rows = jax.lax.all_gather(rows, axis)  # (D, ...) global queries
    loc = all_rows - jnp.asarray(d, all_rows.dtype) * rps
    ok = (loc >= 0) & (loc < rps)
    vals = stripe[jnp.clip(loc, 0, rps - 1)]
    mask = ok if stripe.ndim == 1 else ok[..., None]
    vals = jnp.where(mask, vals, jnp.zeros((), vals.dtype))
    # each row is owned by exactly one shard -> sum-combine
    return jax.lax.psum_scatter(vals, axis, scatter_dimension=0,
                                tiled=False)


def _row_gather_routed(stripe, rows, axis):
    """Owner-routed lookup: bucket this device's queries by owning shard
    (sort by owner), all_to_all the row ids to their owners, answer with
    one local gather, all_to_all the values straight back — point-to-
    point traffic instead of the all-gather pattern's broadcast+reduce.

    Per backward step and device this moves ~2*cap*D row ids + cap*D
    value rows, vs. D x (row ids) + (D-1) x (value rows) for
    _row_gather_ag — with cap = 2*ceil(Q/D), ~3-4x fewer bytes at D=8
    and better with D (SURVEY.md §7 step 2's locality lever; the sort IS
    the batching).  Rank rows of a lockstep backward-search step are
    near-uniform over shards, so the 2x bucket slack virtually never
    overflows; a psum'd (device-uniform) overflow flag falls back to
    _row_gather_ag for that step when it does (adversarial repeat
    pile-ups)."""
    D = jax.lax.psum(1, axis)  # static mesh size
    rps = stripe.shape[0]
    shape = rows.shape
    q = rows.reshape(-1)
    Q = q.shape[0]
    cap = -(-2 * Q // D)
    cap = (cap + 7) & ~7
    if cap * D >= 2 * Q + D * 8:  # tiny query sets: routing buys nothing
        return _row_gather_ag(stripe, rows, axis)
    pdt = q.dtype
    owner = jnp.clip(q // rps, 0, D - 1).astype(jnp.int32)

    order = jnp.argsort(owner, stable=True)
    so = owner[order]
    pos = jnp.arange(Q, dtype=jnp.int32)
    seg_start = jax.lax.cummax(
        jnp.where(jnp.concatenate([jnp.ones(1, bool), so[1:] != so[:-1]]),
                  pos, 0)
    )
    rank = pos - seg_start
    over = jax.lax.psum((rank >= cap).any().astype(jnp.int32), axis) > 0

    def routed(_):
        slot = jnp.where(rank < cap, so * cap + rank, D * cap - 1)
        sendrows = jnp.full((D * cap,), -1, pdt).at[slot].set(
            q[order], mode="drop"
        )
        # slot D*cap-1 may hold a clamped duplicate; harmless (over is
        # False on this branch, so every rank < cap and slots are unique)
        x = sendrows.reshape(D, cap)
        recv = jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0)
        d = jax.lax.axis_index(axis)
        loc = recv.reshape(-1) - jnp.asarray(d, pdt) * rps
        ok = (loc >= 0) & (loc < rps)
        vals = stripe[jnp.clip(loc, 0, rps - 1)]
        mask = ok if stripe.ndim == 1 else ok[..., None]
        vals = jnp.where(mask, vals, jnp.zeros((), vals.dtype))
        vals = vals.reshape((D, cap) + stripe.shape[1:])
        back = jax.lax.all_to_all(vals, axis, split_axis=0, concat_axis=0)
        flat = back.reshape((D * cap,) + stripe.shape[1:])
        out_sorted = flat[jnp.clip(slot, 0, D * cap - 1)]
        inv = jnp.argsort(order)
        return out_sorted[inv]

    def fallback(_):
        return _row_gather_ag(stripe, q, axis)

    out = jax.lax.cond(over, fallback, routed, None)
    return out.reshape(shape + stripe.shape[1:])


def _global_any(x, axis):
    """any(x), reduced over the mesh axis when sharded so lockstep
    while-loops (whose bodies contain collectives) terminate together."""
    v = jnp.any(x)
    if axis is None:
        return v
    return jax.lax.psum(v.astype(jnp.int32), axis) > 0


def _occ_finish(arrs, res, c, is_total, is_none, pdt):
    """Boundary handling shared by the occ layouts: k == seq_len returns
    the char total, k < 0 returns 0 (bwt_occ, lib/bwa/bwt.c:109-112)."""
    total = (arrs["L2"][c + 1] - arrs["L2"][c]).astype(pdt)
    res = jnp.where(is_total, total, res)
    return jnp.where(is_none, 0, res)


def occ(arrs, meta, k, c, axis=None):
    """Occ(c, k): count of char c in the $-removed BWT prefix at row k.

    Semantics of bwt_occ (lib/bwa/bwt.c:107-129) including the primary-row
    adjustment; k in [-1, seq_len], c in [0, 3].  Shapes broadcast.
    axis: mesh axis name when the block arrays are row-sharded (see
    _row_gather).
    """
    pdt = jnp.asarray(k).dtype
    seq_len = meta["seq_len"]
    primary = meta["primary"]
    k = jnp.asarray(k)
    c = jnp.asarray(c)
    k, c = jnp.broadcast_arrays(k, c)

    is_total = k == seq_len
    is_none = k < 0
    kk = jnp.clip(k, 0, seq_len - 1)
    kp = kk - (kk >= primary).astype(pdt)

    blk = kp >> 7
    off = (kp & 127).astype(jnp.uint32)
    if "fm_blocks" in arrs:
        # fused layout: checkpoint + block words in ONE 48-byte row gather.
        # The checkpoint select and the in-block popcount are folded into a
        # single 12-lane reduction so XLA keeps them in one gather fusion
        # (two separate reduces get split into two 128k-row gathers).
        row = _row_gather(arrs["fm_blocks"], blk, axis)  # (..., 12) uint32
        lane12 = jnp.arange(12, dtype=jnp.int32)
        c32 = c.astype(jnp.uint32)[..., None]
        hi = jnp.where((c32 & 2) != 0, row, ~row)
        lo = jnp.where((c32 & 1) != 0, row, ~row)
        matched = (hi >> jnp.uint32(1)) & lo & jnp.uint32(0x55555555)

        f = (off >> 4).astype(jnp.int32)[..., None]  # word holding the row
        r = (off & 15)[..., None]
        wlane = lane12 - 4
        partial = (
            ~((jnp.uint32(1) << ((jnp.uint32(15) - r) << 1)) - 1)
        ).astype(jnp.uint32)
        cover = jnp.where(
            wlane < f,
            jnp.uint32(0xFFFFFFFF),
            jnp.where(wlane == f, partial, jnp.uint32(0)),
        )
        pc = jax.lax.population_count(matched & cover)
        contrib = jnp.where(
            lane12 < 4,
            jnp.where(lane12 == c.astype(jnp.int32)[..., None], row, 0),
            pc,
        )
        return _occ_finish(arrs, contrib.sum(axis=-1).astype(pdt),
                           c, is_total, is_none, pdt)
    else:
        cp = _row_gather(arrs["occ_cp"], blk, axis)  # (..., 4)
        base = jnp.take_along_axis(
            cp, c.astype(jnp.int32)[..., None], axis=-1
        )[..., 0].astype(pdt)

        # in-block popcount over 8 uint32 words (16 bases each); one row
        # gather of 32 contiguous bytes per lane (bwa's interleaving
        # rationale, lib/bwa/bwt.h:72-78, applied to HBM burst efficiency)
        w = _row_gather(arrs["bwt_blocks"], blk, axis)  # (..., 8) uint32
    c32 = c.astype(jnp.uint32)[..., None]
    hi = jnp.where((c32 & 2) != 0, w, ~w)
    lo = jnp.where((c32 & 1) != 0, w, ~w)
    matched = (hi >> jnp.uint32(1)) & lo & jnp.uint32(0x55555555)

    f = (off >> 4).astype(jnp.int32)[..., None]  # word holding the row
    r = (off & 15)[..., None]  # base offset within it
    lane = jnp.arange(8, dtype=jnp.int32)
    partial = (~((jnp.uint32(1) << ((jnp.uint32(15) - r) << 1)) - 1)).astype(
        jnp.uint32
    )
    cover = jnp.where(
        lane < f,
        jnp.uint32(0xFFFFFFFF),
        jnp.where(lane == f, partial, jnp.uint32(0)),
    )
    cnt = jax.lax.population_count(matched & cover).sum(axis=-1).astype(pdt)

    total = (arrs["L2"][c + 1] - arrs["L2"][c]).astype(pdt)
    res = base + cnt
    res = jnp.where(is_total, total, res)
    res = jnp.where(is_none, 0, res)
    return res


def backward_ext(arrs, meta, k, l, c, axis=None):
    """One backward-search step: [k, l] -> interval of c+pattern
    (bwt_count_exact inner step, src/BWT.cpp:255-258).

    The two rank queries are stacked into ONE occ call so the block
    gathers issue as a single larger gather (the device analogue of
    bwa's bwt_2occ fusion, lib/bwa/bwt.c:132-166)."""
    both = occ(arrs, meta, jnp.stack([k - 1, l]), c[None], axis=axis)
    ok, ol = both[0], both[1]
    L2c = arrs["L2"][c].astype(jnp.asarray(k).dtype)
    return L2c + ok + 1, L2c + ol


def bwt_b0(arrs, k, axis=None):
    """BWT char at $-removed position k (bwt_B0, lib/bwa/bwt.h:78)."""
    w = _row_gather(arrs["bwt_words"], k >> 4, axis)
    sh = ((((~k) & 15) << 1)).astype(jnp.uint32)
    return ((w >> sh) & 3).astype(jnp.asarray(k).dtype)


def sa_lookup(arrs, meta, rows, valid, axis=None):
    """SA values for a batch of rows: lockstep inverse-Psi walk until a
    sampled row (bwt_sa, lib/bwa/bwt.c:86-96).  rows outside ``valid`` are
    untouched and return 0."""
    pdt = rows.dtype
    primary = meta["primary"]
    intv = meta["sa_intv"]
    if intv == 1:  # full SA on device: locate is a single gather
        return jnp.where(
            valid, _row_gather(arrs["sa_samp"], rows, axis).astype(pdt), 0
        )
    mask = intv - 1
    log2_intv = int(intv).bit_length() - 1

    def walk(rows, steps, active, max_steps=None):
        def cond(state):
            out = state[3]
            if max_steps is not None:
                out = out & (state[4] < max_steps)
            return out

        def body(state):
            rows, steps, active, _, it = state
            k = rows
            # bwt_invPsi (lib/bwa/bwt.c:53-59)
            x = k - (k > primary).astype(pdt)
            ch = bwt_b0(arrs, x, axis=axis)
            nxt = arrs["L2"][ch].astype(pdt) + occ(arrs, meta, k, ch,
                                                   axis=axis)
            nxt = jnp.where(k == primary, 0, nxt).astype(pdt)
            rows = jnp.where(active, nxt, rows)
            steps = steps + active.astype(pdt)
            active = active & ((rows & mask) != 0)
            return (rows, steps, active, _global_any(active, axis),
                    it + jnp.int32(1))

        rows, steps, active, _, _ = jax.lax.while_loop(
            cond, body,
            (rows, steps, active, _global_any(active, axis), jnp.int32(0)),
        )
        return rows, steps, active

    steps0 = jnp.zeros_like(rows)
    active0 = valid & ((rows & mask) != 0)

    flat = rows.ndim == 1
    n = rows.shape[0] if flat else 0
    if axis is None and flat and n >= (1 << 16) and intv >= 8:
        # Phased walk with lane compaction: expected remaining walk
        # length is uniform in [0, intv), so after intv/2 steps about
        # half the lanes have hit a sampled row.  Compact the survivors
        # to half width and finish there — roughly halves the rank
        # gather volume of locate, the dominant seeding cost at Gbp
        # scale (the walk gathers 48-byte rank rows per lane per step
        # over the multi-GB index).  Falls back to the full-width walk
        # if survivors exceed the cap (skewed row distributions).
        half = intv // 2
        rows1, steps1, act1 = walk(rows, steps0, active0, max_steps=half)

        cap = n // 2

        def take(st):
            r1, s1, a1 = st
            _, sel = jax.lax.top_k(a1.astype(jnp.int32), cap)
            r2, s2, _ = walk(r1[sel], s1[sel], a1[sel])
            return r1.at[sel].set(r2), s1.at[sel].set(s2)

        def fall(st):
            r1, s1, a1 = st
            r2, s2, _ = walk(r1, s1, a1)
            return r2, s2

        rows_f, steps_f = jax.lax.cond(
            act1.sum() <= cap, take, fall, (rows1, steps1, act1)
        )
    else:
        rows_f, steps_f, _ = walk(rows, steps0, active0)
    sa = steps_f + _row_gather(
        arrs["sa_samp"], rows_f >> log2_intv, axis
    ).astype(pdt)
    return jnp.where(valid, sa, 0)


class SeedBatch(NamedTuple):
    """Padded per-read seed tensors; the device analogue of the
    forward/reverse SeedList pair (src/LordFAST.h:37-41)."""

    t_pos: jnp.ndarray   # (B, MS) target position (forward-genome coords)
    q_pos: jnp.ndarray   # (B, MS) query position (strand-local, like ref)
    length: jnp.ndarray  # (B, MS) anchor length
    is_rev: jnp.ndarray  # (B, MS) bool strand
    valid: jnp.ndarray   # (B, MS) bool
    n_total: jnp.ndarray     # (B,) hits found (before the MS cap)
    n_anchors: jnp.ndarray   # (B,) accepted anchors


def sample_positions_host(read_lens, sampling_count):
    """Anchor sampling positions, bit-exact with the reference's float
    accumulation (src/BWT.cpp:320-328: seed_pos += step in double, then
    truncate).  Computed on the host: numpy's sequential float64 cumsum
    reproduces the C loop's IEEE addition order, which XLA would not
    guarantee (it may strength-reduce the division / reorder the sum)."""
    import numpy as np

    read_lens = np.asarray(read_lens, dtype=np.int64)
    step = read_lens.astype(np.float64) / sampling_count  # (B,)
    acc = np.zeros((len(read_lens), sampling_count), dtype=np.float64)
    acc[:, 1:] = np.cumsum(
        np.repeat(step[:, None], sampling_count - 1, axis=1), axis=1
    )
    return acc.astype(np.int32)  # truncation toward zero, like (uint32) cast


@functools.partial(
    jax.jit,
    static_argnames=(
        "meta_t", "sampling_count", "min_anchor_len", "max_ref_hits",
        "max_seeds", "phase1_steps", "compact_frac", "axis",
    ),
)
def _seed_anchors_impl(
    arrs, reads, read_lens, pos, meta_t, sampling_count, min_anchor_len,
    max_ref_hits, max_seeds, phase1_steps=24, compact_frac=8, axis=None,
):
    meta = dict(meta_t)
    pdt = jnp.int32 if meta["seq_len"] < 2**31 - 1 else jnp.int64
    B, L = reads.shape
    S = sampling_count
    kc = meta["kcache_k"]
    assert kc <= 17, "k-mer cache k must fit a 2-word read window"
    l_pac = meta["l_pac"]
    reads_i = reads.astype(jnp.int32)

    # ---- lockstep greedy extension (two-phase) ----
    # Most lanes stop extending early (noisy reads: anchor length is
    # near-geometric past the cache k-mer), but a lockstep loop costs a
    # full-width gather per step until the LAST lane finishes.  Phase 1
    # runs `phase1_steps` full-width steps; phase 2 compacts the (few)
    # still-alive lanes into a BS/compact_frac buffer and finishes only
    # those, falling back to the full-width loop if more lanes survive
    # (repeat-rich genomes).
    max_ext = MAX_ANCHOR_LEN
    BS = B * S
    b_lane = (jnp.arange(BS, dtype=jnp.int32) // S)  # flat lane -> read row

    # Packed read words: 16 chars x 3 bits in one uint64, so the per-step
    # per-lane read-char fetch (a full-width gather, ~20% of the loop) is
    # replaced by a 2-word window refill every 16 steps.
    Lp = ((L + 15) // 16) * 16
    reads_p = reads_i if Lp == L else jnp.pad(
        reads_i, ((0, 0), (0, Lp - L)), constant_values=4
    )
    W16 = Lp // 16
    j16 = jnp.arange(16, dtype=jnp.uint64)
    rw = (
        reads_p.reshape(B, W16, 16).astype(jnp.uint64)
        << (3 * (15 - j16))
    ).sum(-1, dtype=jnp.uint64)  # (B, W16)

    # ---- k-mer cache lookup on revcomp(anchor[0:kc]) ----
    # cache index = sum_j comp(read[p+j]) * 4^(kc-1-j)  (encoding matches
    # bwt_count_exact_cached, src/BWT.cpp:270-277).  The kc chars come out
    # of the same 2-word packed window the extension loop uses — one u64
    # row gather per word instead of a (B, S, kc) element gather.
    pos_f = pos.reshape(BS)
    q0 = jnp.clip(pos_f, 0, L - 1)
    w0 = q0 >> 4
    lo0 = rw[b_lane, w0]
    hi0 = rw[b_lane, jnp.minimum(w0 + 1, W16 - 1)]
    jj = jnp.arange(kc, dtype=jnp.int32)
    qj = pos_f[:, None] + jj  # (BS, kc)
    word = jnp.where((qj >> 4) == w0[:, None], lo0[:, None], hi0[:, None])
    ch = (
        (word >> (3 * (15 - (qj & 15))).astype(jnp.uint64)) & jnp.uint64(7)
    ).astype(jnp.int32)
    in_range = qj < read_lens[b_lane][:, None]
    ch = jnp.where(in_range, ch, 4)
    has_n = jnp.any(ch >= 4, axis=-1)
    comp = jnp.where(ch < 4, 3 - ch, 0)
    weights = (4 ** (kc - 1 - jj)).astype(pdt)
    ci = (comp.astype(pdt) * weights).sum(-1)  # (BS,)
    k0 = arrs["kcache_beg"][ci].astype(pdt)
    l0 = arrs["kcache_end"][ci].astype(pdt)
    alive0 = (~has_n) & (k0 <= l0) & (pos_f + kc <= read_lens[b_lane])

    def _ext_body(st, posf, bf):
        alive, k, l, m, i, lo, hi, bw, _ = st

        def refill(_):
            q0 = jnp.clip(posf + m, 0, L - 1)
            w0 = q0 >> 4
            w1 = jnp.minimum(w0 + 1, W16 - 1)
            return rw[bf, w0], rw[bf, w1], w0

        lo, hi, bw = jax.lax.cond(
            i % 16 == 0, refill, lambda _: (lo, hi, bw), None
        )
        q = posf + m  # next read position to consume
        in_rd = q < read_lens[bf]
        qc = jnp.clip(q, 0, L - 1)
        word = jnp.where((qc >> 4) == bw, lo, hi)
        shift = (3 * (15 - (qc & 15))).astype(jnp.uint64)
        c = ((word >> shift) & jnp.uint64(7)).astype(jnp.int32)
        ok_char = in_rd & (c < 4)
        cc = jnp.where(ok_char, 3 - c, 0).astype(pdt)  # complemented
        nk, nl = backward_ext(arrs, meta, k, l, cc, axis=axis)
        success = alive & ok_char & (nk <= nl) & (m < max_ext)
        k = jnp.where(success, nk, k)
        l = jnp.where(success, nl, l)
        m = jnp.where(success, m + 1, m)
        return (success, k, l, m, i + 1, lo, hi, bw,
                _global_any(success, axis))

    def _carry0(alive, k, l, m):
        z64 = jnp.zeros_like(m, dtype=jnp.uint64)
        return (alive, k, l, m, jnp.int32(0), z64, z64, jnp.zeros_like(m),
                _global_any(alive, axis))

    def ext_loop_flat(alive, k, l, m, posf, bf, max_steps=None):
        def cond(st):
            out = st[8]
            if max_steps is not None:
                out = out & (st[4] < max_steps)
            return out

        st = jax.lax.while_loop(
            cond, lambda st: _ext_body(st, posf, bf), _carry0(alive, k, l, m)
        )
        return st[0], st[1], st[2], st[3]

    def _resolve_rounds(one, k, m, posf_s, bf_s):
        """Comparison rounds for a (compacted) lane set; see
        resolve_one_hits.

        Gather-free formulation: per round each lane touches only two
        SMALL row gathers (9 consecutive text words, 9 consecutive read
        words); the per-position extraction is word unpacking (static
        shifts) + a 16-way static-slice select on the lane's in-word
        offset instead of per-element take_along_axis gathers."""
        p = sa_lookup(arrs, meta, k, one, axis=axis).astype(pdt)
        CH = 128
        NW = CH // 16 + 1  # 9 words cover any 128-char window
        jj = jnp.arange(CH, dtype=jnp.int32)
        wj = jnp.arange(NW, dtype=pdt)
        seq_len_c = jnp.asarray(meta["seq_len"], pdt)
        t_sh = (jnp.uint32(2) * (15 - jnp.arange(16, dtype=jnp.uint32)))
        r_sh = (jnp.uint64(3) * (15 - jnp.arange(16, dtype=jnp.uint64)))

        def cond(st):
            return st[2]

        def body(st):
            m_c, p_c, _, act = st
            V = m_c.shape[0]
            # --- text window [p-CH, p), unpacked LSB-pos-last ---
            # arithmetic shift keeps the in-word offset in [128, 143]
            # even for p < CH (rows clip; garbage is masked by j < p)
            base_w = (p_c.astype(pdt) - CH) >> 4
            rows = jnp.clip(base_w[:, None] + wj[None, :], 0,
                            (seq_len_c - 1) >> 4)
            twords = _row_gather(arrs["pac_words"], rows, axis)  # (V, NW)
            tw = ((twords[:, :, None] >> t_sh[None, None, :]) & 3).astype(
                jnp.int8).reshape(V, NW * 16)
            twr = tw[:, ::-1]  # twr[i] = text[base*16 + 143 - i]
            off = (p_c.astype(pdt) - (base_w << 4)).astype(jnp.int32)
            s_t = 144 - off  # in [1, 16]
            tc = jnp.zeros((V, CH), jnp.int8)
            for st_ in range(1, 17):
                tc = jnp.where(s_t[:, None] == st_,
                               jax.lax.slice_in_dim(twr, st_, st_ + CH,
                                                    axis=1), tc)
            # --- read window [q0, q0+CH), 3-bit packed u64 words ---
            q0 = posf_s + m_c
            base_r = jnp.clip(q0 >> 4, 0, W16 - 1)
            rrows = jnp.clip(base_r[:, None]
                             + jnp.arange(NW, dtype=jnp.int32)[None, :],
                             0, W16 - 1)
            rwords = rw[bf_s[:, None], rrows]  # (V, NW) u64
            rwin = ((rwords[:, :, None] >> r_sh[None, None, :])
                    & jnp.uint64(7)).astype(jnp.int8).reshape(V, NW * 16)
            offr = (q0 & 15).astype(jnp.int32)  # in [0, 15]
            rc = jnp.full((V, CH), jnp.int8(4))
            for sr in range(16):
                rc = jnp.where(offr[:, None] == sr,
                               jax.lax.slice_in_dim(rwin, sr, sr + CH,
                                                    axis=1), rc)
            in_rd = ((q0[:, None] + jj[None, :]) < read_lens[bf_s][:, None]
                     ) & (rc < 4)
            eq = (act[:, None] & in_rd
                  & (jj[None, :] < jnp.minimum(p_c, CH)[:, None])
                  & (tc == 3 - rc)
                  & ((m_c[:, None] + jj[None, :]) < max_ext))
            all_eq = jnp.all(eq, axis=1)
            run = jnp.where(all_eq, CH, jnp.argmax(~eq, axis=1)
                            .astype(jnp.int32))
            m_c = m_c + run
            p_c = p_c - run.astype(p_c.dtype)
            act = act & all_eq
            return m_c, p_c, _global_any(act, axis), act

        m_f, p_f, _, _ = jax.lax.while_loop(
            cond, body, (m, p, _global_any(one, axis), one)
        )
        return jnp.where(one, m_f, m), jnp.where(one, p_f, 0)

    def resolve_one_hits(alive, k, l, m, posf, bf):
        """occ==1 fast path: a single-row interval can only shrink to 0,
        so the rest of the greedy extension is "does the text to the left
        of the unique occurrence keep matching the (complemented) read" —
        answered by direct comparison against the packed text instead of
        one sequential rank query per base.  This collapses the long
        extension tail (noiseless reads produce kilobase exact matches =
        thousands of lockstep rank steps) into a few 128-char compare
        rounds.  The one-hit lanes are compacted to <= R before the
        (V, 128)-shaped rounds so full-width lanes never pay the compare
        cost; one-hit lanes beyond R simply stay in the rank-step loop
        and get picked up at the next level.  Returns (resolved,
        m_final, p_final): p_final is the occurrence position in mirror
        space, m_final the final anchor length."""
        width = m.shape[0]
        one = alive & (k == l)
        R = min(width, 16384)
        if R == width:
            m_f, p_f = _resolve_rounds(one, k, m, posf, bf)
            return one, m_f, p_f
        _, sel = jax.lax.top_k(one.astype(jnp.int32), R)
        one_s = one[sel]
        m_s, p_s = _resolve_rounds(one_s, k[sel], m[sel], posf[sel],
                                   bf[sel])
        resolved = jnp.zeros_like(one).at[sel].set(one_s)
        m_f = m.at[sel].set(m_s)
        p_f = jnp.zeros(width, pdt).at[sel].set(p_s)
        return resolved, m_f, p_f

    def staged_ext(alive, k, l, m, rpos, rflag, posf, bf, caps):
        """Run `phase1_steps` steps at the current width, resolve occ==1
        lanes by direct text comparison, then compact the remaining alive
        lanes to caps[0] and recurse; when more lanes than the cap
        survive (repeat-rich genomes) finish at the current width
        instead.  The last level runs to completion."""
        if not caps:
            alive, k, l, m = ext_loop_flat(
                alive, k, l, m, posf, bf, max_steps=phase1_steps
            )
            one, m, rp = resolve_one_hits(alive, k, l, m, posf, bf)
            rpos = jnp.where(one, rp, rpos)
            rflag = rflag | one
            _, k2, l2, m2 = ext_loop_flat(alive & ~one, k, l, m, posf, bf)
            return k2, l2, m2, rpos, rflag
        alive, k, l, m = ext_loop_flat(
            alive, k, l, m, posf, bf, max_steps=phase1_steps
        )
        one, m, rp = resolve_one_hits(alive, k, l, m, posf, bf)
        rpos = jnp.where(one, rp, rpos)
        rflag = rflag | one
        alive = alive & ~one
        cap = caps[0]

        def take(st):
            a2, k2, l2, m2, rpos2, rflag2 = st
            _, sel = jax.lax.top_k(a2.astype(jnp.int32), cap)
            rk, rl, rm, rrp, rrf = staged_ext(
                a2[sel], k2[sel], l2[sel], m2[sel], rpos2[sel],
                rflag2[sel], posf[sel], bf[sel], caps[1:],
            )
            return (k2.at[sel].set(rk), l2.at[sel].set(rl),
                    m2.at[sel].set(rm), rpos2.at[sel].set(rrp),
                    rflag2.at[sel].set(rrf))

        def fall(st):
            # more lanes than the cap survive: step a bounded stretch at
            # the current width, resolve the occ==1 lanes that emerged,
            # then finish — so a mis-sized cap degrades gracefully
            # instead of running kilobase tails at full width
            a2, k2, l2, m2, rpos2, rflag2 = st
            a2, k2, l2, m2 = ext_loop_flat(
                a2, k2, l2, m2, posf, bf, max_steps=4 * phase1_steps
            )
            one2, m2, rp2 = resolve_one_hits(a2, k2, l2, m2, posf, bf)
            rpos2 = jnp.where(one2, rp2, rpos2)
            rflag2 = rflag2 | one2
            _, k3, l3, m3 = ext_loop_flat(a2 & ~one2, k2, l2, m2, posf, bf)
            return k3, l3, m3, rpos2, rflag2

        return jax.lax.cond(alive.sum() <= cap, take, fall,
                            (alive, k, l, m, rpos, rflag))

    m0 = jnp.full((BS,), kc, dtype=jnp.int32)
    rpos0 = jnp.zeros((BS,), pdt)
    rflag0 = jnp.zeros((BS,), bool)
    caps = []
    if axis is None:
        # staged compaction takes a data-dependent branch per device;
        # under a sharded index every step is a collective, so all
        # devices must trace the same path -> plain lockstep loop there
        c = BS // compact_frac
        while c > 512:
            caps.append(max(c, 256))
            c //= 3
    if axis is None:
        kf, lf, mf, rposf, rflagf = staged_ext(
            alive0, k0, l0, m0, rpos0, rflag0, pos_f, b_lane, caps
        )
    else:
        # sharded index: plain lockstep loop (collectives per step must
        # trace identically on every device); no occ==1 fast path
        _, kf, lf, mf = ext_loop_flat(alive0, k0, l0, m0, pos_f, b_lane)
        rposf, rflagf = rpos0, rflag0
    kf = kf.reshape(B, S)
    lf = lf.reshape(B, S)
    mf = mf.reshape(B, S)
    rposf = rposf.reshape(B, S)
    rflagf = rflagf.reshape(B, S)

    occ_cnt = jnp.where(
        alive0.reshape(B, S) & (kf <= lf), (lf - kf + 1).astype(jnp.int32), 0
    )

    # ---- acceptance: occ in (0, max_ref_hits), length >= min, not
    # contained (sequential last_pos scan, src/BWT.cpp:345,386) ----
    base_ok = (occ_cnt > 0) & (occ_cnt < max_ref_hits) & (mf >= min_anchor_len)

    # Containment filter (src/BWT.cpp:345,386): an anchor is accepted iff
    # its end exceeds the last ACCEPTED end.  The accepted-prefix max
    # always equals the running max over all passing anchors (a new
    # maximum necessarily exceeds the previous accepted max, so it is
    # itself accepted), so the sequential scan reduces to an exclusive
    # cumulative max — parallel-friendly for XLA.
    ends = jnp.where(base_ok, pos + mf, 0)
    prev_max = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32),
         jax.lax.cummax(ends, axis=1)[:, :-1]], axis=1
    )
    accept = base_ok & ((pos + mf) > prev_max)

    # ---- locate: flatten accepted intervals into <= max_seeds slots ----
    occ_acc = jnp.where(accept, occ_cnt, 0)
    starts = jnp.cumsum(occ_acc, axis=1) - occ_acc  # exclusive prefix (B,S)
    total = occ_acc.sum(axis=1)  # (B,)

    slot = jnp.arange(max_seeds, dtype=jnp.int32)
    bidx = jnp.arange(B)[:, None]
    # anchor owning slot t: the last accepted anchor s with starts[s] <= t.
    # Accepted anchors with occ > 0 have strictly increasing starts, so a
    # scatter of s at starts[s] followed by a running max gives the owner
    # of every slot directly — O(S + max_seeds) instead of the O(max_seeds
    # log S) batched binary search (a vmap'd while-loop).
    has_occ = accept & (occ_acc > 0)
    tgt = jnp.where(has_occ & (starts < max_seeds), starts, max_seeds)
    scat = jnp.full((B, max_seeds), -1, jnp.int32)
    scat = scat.at[bidx, tgt].max(
        jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None, :], (B, S)),
        mode="drop",
    )
    sidx = jnp.clip(jax.lax.cummax(scat, axis=1), 0, S - 1)
    slot_valid = slot[None, :] < total[:, None]
    row = kf[bidx, sidx].astype(pdt) + (slot - starts[bidx, sidx]).astype(pdt)
    row = jnp.where(slot_valid, row, 0)

    # anchors resolved by the occ==1 fast path carry their (already
    # located) occurrence position; their kf row is stale (it predates
    # the comparison-resolved extension tail), so skip the SA walk
    res_f = rflagf[bidx, sidx]
    walk_mask = slot_valid & ~res_f
    if axis is None and B * max_seeds >= (1 << 17):
        # compact the lanes that actually walk (typically well under
        # half the padded slots) before the inverse-Psi walk — its rank
        # gathers over the multi-GB index dominate seeding at Gbp scale
        flat_rows = row.reshape(-1)
        flat_valid = walk_mask.reshape(-1)
        cap = (B * max_seeds) // 2

        def take(_):
            _, sel = jax.lax.top_k(flat_valid.astype(jnp.int32), cap)
            sub = sa_lookup(arrs, meta, flat_rows[sel], flat_valid[sel])
            return jnp.zeros_like(flat_rows).at[sel].set(sub)

        def fall(_):
            return sa_lookup(arrs, meta, flat_rows, flat_valid)

        p_occ = jax.lax.cond(
            flat_valid.sum() <= cap, take, fall, None
        ).reshape(B, max_seeds)
    else:
        p_occ = sa_lookup(arrs, meta, row, walk_mask, axis=axis)
    p_occ = jnp.where(res_f, rposf[bidx, sidx].astype(pdt), p_occ)

    # ---- mirror back to the reference's seed coordinates ----
    m_s = mf[bidx, sidx]
    p_s = pos[bidx, sidx]
    p_P = (2 * l_pac - p_occ - m_s).astype(pdt)  # occurrence of the anchor
    is_fwd = p_P < l_pac
    t_pos = jnp.where(is_fwd, p_P, p_occ)
    q_pos = jnp.where(is_fwd, p_s, read_lens[:, None] - p_s - m_s)

    return SeedBatch(
        t_pos=jnp.where(slot_valid, t_pos, 0).astype(pdt),
        q_pos=jnp.where(slot_valid, q_pos, 0).astype(jnp.int32),
        length=jnp.where(slot_valid, m_s, 0).astype(jnp.int32),
        is_rev=jnp.where(slot_valid, ~is_fwd, False),
        valid=slot_valid,
        n_total=total,
        n_anchors=accept.sum(axis=1).astype(jnp.int32),
    )


def seed_anchors(arrs, meta, reads, read_lens, cfg):
    """Run the seeding stage for a padded read batch.

    reads: (B, L) uint8 codes 0..4 (4 = N / pad); read_lens: (B,) int32.
    Returns a SeedBatch with up to cfg.max_seeds_per_read seeds per read
    across both strands.
    """
    meta_t = tuple(sorted((k, v) for k, v in meta.items() if k != "pos_dtype"))
    pos = sample_positions_host(read_lens, cfg.sampling_count)
    return _seed_anchors_impl(
        arrs,
        jnp.asarray(reads),
        jnp.asarray(read_lens, dtype=jnp.int32),
        jnp.asarray(pos),
        meta_t,
        cfg.sampling_count,
        cfg.min_anchor_len,
        cfg.max_ref_hits,
        cfg.max_seeds_per_read,
        cfg.seed_phase1_steps,
        cfg.seed_compact_frac,
    )

"""Window voting and candidate selection (device, pure jnp).

Batched sparse re-design of ``findTopWins_coarse`` / ``findTopWins_fine``
(src/LordFAST.cpp:582-657, 819-904).  The reference scans a genome-sized
per-thread counter array per read; here votes are sparse: each seed votes
(weight = 1 + len - MIN_ANCHOR_LEN, src/LordFAST.cpp:593) into windows
``winId = tPos / readLen`` and ``winId - 1`` (src/LordFAST.cpp:590-619),
the votes are sorted per read, segment-summed, and local maxima are found
by comparing adjacent (winId, strand) groups — exactly the neighbor
conditions of src/LordFAST.cpp:630-632 (an absent neighbor passes).

Output: the top ``max_candidates`` windows per read by vote count, plus
the coarse-mode decision (best >= scoreRatio * second,
src/LordFAST.cpp:542-543) and the fine-mode threshold minScore = best /
scoreRatio (src/LordFAST.cpp:553).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class CandidateBatch(NamedTuple):
    win_id: jnp.ndarray     # (B, C) int32, window index (tStart = w * rl)
    is_rev: jnp.ndarray     # (B, C) bool
    cnt: jnp.ndarray        # (B, C) int32 vote count, descending
    valid: jnp.ndarray      # (B, C) bool
    is_fine: jnp.ndarray    # (B,) bool: fine mode (chain-score re-ranking)
    min_score: jnp.ndarray  # (B,) float32: fine-mode vote threshold


def vote_windows(seeds, read_lens, cfg, page=None):
    """seeds: SeedBatch; read_lens: (B,) int32.

    Dispatcher: the flat path gathers every read's (contiguous) valid
    seeds into one F-slot vote stream and sorts THAT — ~8x fewer sorted
    elements than the padded (B, 2*max_seeds) layout when seed tensors
    are mostly padding (the common case).  Batches whose total vote
    count exceeds F fall back to the wide per-read path; both produce
    identical CandidateBatch results.

    page: optional traced int32 — return candidate ranks
    [C*page, C*(page+1)) instead of the top C, with is_fine/min_score
    still computed from the GLOBAL top two.  This powers the engine's
    window paging for reads with more qualifying windows than one
    pipeline budget (the reference chains every qualifying window,
    src/LordFAST.cpp:874-904); page=None keeps the original HLO."""
    B, MS = seeds.t_pos.shape
    F = 131072
    if 2 * B * MS <= F:
        return _vote_windows_wide(seeds, read_lens, cfg, page)
    total_votes = 2 * seeds.n_total.astype(jnp.int32).sum()
    return jax.lax.cond(
        total_votes <= F,
        lambda ops: _vote_windows_flat(*ops, cfg, F, page),
        lambda ops: _vote_windows_wide(*ops, cfg, page),
        (seeds, read_lens),
    )


def _vote_windows_flat(seeds, read_lens, cfg, F: int, page=None):
    """Flat-compacted voting: seeds' valid slots are contiguous per read
    (fm_index locate fills slots 0..n-1), so vote v of the global stream
    maps back to (read, slot, which-vote) with a searchsorted over the
    per-read offsets — a pure gather, no scatter.  The segment-total /
    local-max logic is the wide path's, on one (1, F) row with the read
    id embedded in the sort key; per-read top-C extraction replicates
    top_k's tie order (score desc, then (strand, win) asc) with a second
    lexicographic sort + rank-limited scatter."""
    B, MS = seeds.t_pos.shape
    C = cfg.max_candidates

    rl = jnp.maximum(read_lens, 1).astype(jnp.int64)[:, None]
    win = (seeds.t_pos.astype(jnp.int64) // rl).astype(jnp.int32)
    weight = (1 + seeds.length - cfg.min_anchor_len).astype(jnp.int32)
    strand = seeds.is_rev.astype(jnp.int32)

    n = seeds.n_total.astype(jnp.int32)  # valid slots per read (<= MS)
    n = jnp.minimum(n, MS)
    off = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(2 * n)])
    v = jnp.arange(F, dtype=jnp.int32)
    b = jnp.clip(jnp.searchsorted(off, v, side="right") - 1, 0, B - 1)
    rel = v - off[b]
    s = jnp.clip(rel >> 1, 0, MS - 1)
    which = rel & 1
    live = v < off[B]

    w_bs = win[b, s] - which
    val = live & seeds.valid[b, s] & (w_bs >= 0)
    # key: (read, strand, win) — adjacency within (read, strand) is +-1
    SENT = jnp.int64(2**62)
    keys = jnp.where(
        val,
        ((b.astype(jnp.int64) * 2 + strand[b, s]) << 30)
        + w_bs.astype(jnp.int64),
        SENT,
    )
    wts = jnp.where(val, weight[b, s], 0)

    keys_s, wts_s = jax.lax.sort((keys, wts), num_keys=1)
    keys_s = keys_s[None, :]
    wts_s = wts_s[None, :]

    ok = keys_s != SENT
    prv = jnp.concatenate(
        [jnp.full((1, 1), -1, jnp.int64), keys_s[:, :-1]], 1
    )
    nxt = jnp.concatenate(
        [keys_s[:, 1:], jnp.full((1, 1), SENT, jnp.int64)], 1
    )
    is_start = (keys_s != prv) & ok
    is_end = (keys_s != nxt) & ok

    cw = jnp.cumsum(wts_s, axis=1)
    startm1 = jax.lax.cummax(jnp.where(is_start, cw - wts_s, 0), axis=1)
    part = cw - startm1
    pos_r = jnp.arange(F - 1, -1, -1, dtype=jnp.int64)[None, :]
    enc = jnp.where(
        is_end, pos_r * jnp.int64(2**32) + part.astype(jnp.int64),
        jnp.int64(-1),
    )
    enc = jax.lax.cummax(enc[:, ::-1], axis=1)[:, ::-1]
    total = (enc & jnp.int64(0xFFFFFFFF)).astype(jnp.int32)

    tot_prev = jnp.concatenate(
        [jnp.zeros((1, 1), jnp.int32), total[:, :-1]], 1
    )
    tot_next = jnp.concatenate(
        [total[:, 1:], jnp.zeros((1, 1), jnp.int32)], 1
    )
    w_id = (keys_s & jnp.int64(2**30 - 1)).astype(jnp.int32)
    left_ok = (w_id == 0) | (prv != keys_s - 1) | (total >= tot_prev)
    pos_f = jnp.arange(F, dtype=jnp.int32)[None, :]
    lenc = jax.lax.cummax(
        jnp.where(is_start, pos_f * 2 + left_ok.astype(jnp.int32), -1),
        axis=1,
    )
    left_ok_e = (lenc & 1) == 1
    right_ok = (nxt != keys_s + 1) | (total > tot_next)
    is_max = (is_end & left_ok_e & right_ok)[0]

    score = jnp.where(is_max, total[0], -1)
    bkey = (keys_s[0] >> 31).astype(jnp.int64)  # read id (or SENT>>31)
    bkey = jnp.clip(bkey, 0, B - 1)
    sw_key = (keys_s[0] & jnp.int64(2**31 - 1)).astype(jnp.int32)
    # second sort: (read, -score) primary, (strand, win) secondary —
    # exactly top_k's tie order on the wide path
    k1 = bkey * jnp.int64(2**32) + (
        jnp.int64(2**31 - 1) - score.astype(jnp.int64)
    )
    k1 = jnp.where(is_max, k1, jnp.int64(2**62))
    k1s, k2s, sc_s = jax.lax.sort((k1, sw_key, score), num_keys=2)
    b2 = jnp.clip((k1s >> 32).astype(jnp.int32), 0, B - 1)
    idx = jnp.arange(F, dtype=jnp.int32)
    is_start2 = jnp.concatenate(
        [jnp.ones(1, bool), b2[1:] != b2[:-1]]
    )
    start_pos = jax.lax.cummax(jnp.where(is_start2, idx, -1))
    rank = idx - start_pos
    live = (k1s != jnp.int64(2**62)) & (sc_s > 0)
    if page is None:
        take = (rank < C) & live
        prank = rank
    else:
        p0 = jnp.asarray(page, jnp.int32) * C
        take = (rank >= p0) & (rank < p0 + C) & live
        prank = rank - p0

    cnt = jnp.zeros((B, C), jnp.int32).at[
        jnp.where(take, b2, 0), jnp.where(take, prank, 0)
    ].max(jnp.where(take, sc_s, 0), mode="drop")
    keyo = jnp.full((B, C), -1, jnp.int32).at[
        jnp.where(take, b2, 0), jnp.where(take, prank, 0)
    ].max(jnp.where(take, k2s, -1), mode="drop")
    valid = cnt > 0

    # best = -1 for candidate-less reads, matching the wide path's
    # top_k over a score array filled with -1 (is_fine/min_score are
    # only consumed when cand_valid0 holds, but the fine-read counter
    # sees them).  On a paged call these come from the GLOBAL ranks
    # 0/1 (scattered separately), so every page agrees on the fine-mode
    # decision and threshold.
    if page is None:
        best = jnp.where(valid[:, 0], cnt[:, 0], -1).astype(jnp.float32)
        second = jnp.where(valid[:, 1], cnt[:, 1], 0).astype(jnp.float32)
    else:
        t0 = (rank == 0) & live
        t1 = (rank == 1) & live
        g0 = jnp.full(B, -1, jnp.int32).at[
            jnp.where(t0, b2, 0)
        ].max(jnp.where(t0, sc_s, -1), mode="drop")
        g1 = jnp.zeros(B, jnp.int32).at[
            jnp.where(t1, b2, 0)
        ].max(jnp.where(t1, sc_s, 0), mode="drop")
        best = g0.astype(jnp.float32)
        second = g1.astype(jnp.float32)
    is_fine = best < cfg.score_ratio * second
    min_score = best / cfg.score_ratio

    return CandidateBatch(
        win_id=jnp.where(valid, keyo & (2**30 - 1), 0),
        is_rev=jnp.where(valid, keyo >= 2**30, False),
        cnt=jnp.where(valid, cnt, 0),
        valid=valid,
        is_fine=is_fine,
        min_score=min_score,
    )


def _vote_windows_wide(seeds, read_lens, cfg, page=None):
    """Per-read padded voting (original path; the flat path's fallback).

    Scatter-free: after the per-read key sort, segment totals and the
    left/right-neighbor local-maximum checks are computed with prefix
    scans (cumsum/cummax propagation within sorted segments) instead of
    scatters of (B, 2*MS) elements.
    """
    B, MS = seeds.t_pos.shape
    C = cfg.max_candidates
    n2 = 2 * MS

    rl = jnp.maximum(read_lens, 1).astype(jnp.int64)[:, None]
    win = (seeds.t_pos.astype(jnp.int64) // rl).astype(jnp.int32)
    weight = (1 + seeds.length - cfg.min_anchor_len).astype(jnp.int32)
    strand = seeds.is_rev.astype(jnp.int32)

    # two votes per seed: winId and winId-1 (skip winId-1 < 0).
    # strand in the high bit: same-strand windows stay adjacent in the
    # sorted key space so neighbor checks see winId +- 1.  Keys fit int32:
    # win < l_pac / min_read_len(>=100) < 2^30 for any supported genome.
    BIGW = jnp.int32(2**30)
    key0 = strand * BIGW + win
    key1 = strand * BIGW + (win - 1)
    SENT = jnp.int32(2**31 - 1)
    keys = jnp.concatenate(
        [
            jnp.where(seeds.valid, key0, SENT),
            jnp.where(seeds.valid & (win >= 1), key1, SENT),
        ],
        axis=1,
    )  # (B, 2*MS)
    wts = jnp.concatenate([weight, weight], axis=1).astype(jnp.int32)
    wts = jnp.where(keys == SENT, 0, wts)

    keys_s, wts_s = jax.lax.sort((keys, wts), num_keys=1)

    ok = keys_s != SENT
    prv = jnp.concatenate([jnp.full((B, 1), -1, jnp.int32), keys_s[:, :-1]], 1)
    nxt = jnp.concatenate([keys_s[:, 1:], jnp.full((B, 1), SENT, jnp.int32)], 1)
    is_start = (keys_s != prv) & ok
    is_end = (keys_s != nxt) & ok

    # full segment total, propagated to every member:
    # total(e) = cumsum at segment end - cumsum at start-1, both obtained
    # by monotone cummax propagation (cumsum is nondecreasing).
    cw = jnp.cumsum(wts_s, axis=1)
    startm1 = jax.lax.cummax(jnp.where(is_start, cw - wts_s, 0), axis=1)
    part = cw - startm1  # partial total; full at segment ends
    # backward propagation of the end value to all members: encode
    # (reverse position, value) so cummax picks the nearest end's total
    pos_r = jnp.arange(n2 - 1, -1, -1, dtype=jnp.int64)[None, :]
    enc = jnp.where(is_end, pos_r * jnp.int64(2**32) + part.astype(jnp.int64),
                    jnp.int64(-1))
    enc = jax.lax.cummax(enc[:, ::-1], axis=1)[:, ::-1]
    total = (enc & jnp.int64(0xFFFFFFFF)).astype(jnp.int32)

    tot_prev = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), total[:, :-1]], 1)
    tot_next = jnp.concatenate([total[:, 1:], jnp.zeros((B, 1), jnp.int32)], 1)
    w_id = keys_s % BIGW
    # local maximum (src/LordFAST.cpp:630-632); absent neighbors pass.
    # left check is local at segment starts (prv is the previous segment's
    # last position), right check at segment ends; the start verdict is
    # propagated to the end by another monotone cummax.
    left_ok = (w_id == 0) | (prv != keys_s - 1) | (total >= tot_prev)
    pos_f = jnp.arange(n2, dtype=jnp.int32)[None, :]
    lenc = jax.lax.cummax(
        jnp.where(is_start, pos_f * 2 + left_ok.astype(jnp.int32), -1), axis=1
    )
    left_ok_e = (lenc & 1) == 1
    right_ok = (nxt != keys_s + 1) | (total > tot_next)
    is_max = is_end & left_ok_e & right_ok

    score = jnp.where(is_max, total, -1)
    if page is None:
        top_cnt, top_pos = jax.lax.top_k(score, C)  # ties: lowest idx 1st
    else:
        # rank window [C*page, C*(page+1)) with top_k's exact tie order
        # (score desc, position asc): one ascending sort of the packed
        # key, then a dynamic slice at the page offset.  31-bit position
        # field: (2^31-1 - score) reaches 2^31 at score=-1, so a 32-bit
        # shift would overflow int64 and sort absent windows first.
        pos_a = jnp.arange(n2, dtype=jnp.int64)[None, :]
        pk = ((jnp.int64(2**31 - 1) - score.astype(jnp.int64)) << 31) \
            | pos_a
        pk_s = jnp.sort(pk, axis=1)
        p0 = jnp.asarray(page, jnp.int32) * C
        sl = jax.lax.dynamic_slice_in_dim(pk_s, p0, C, axis=1)
        top_cnt = (jnp.int64(2**31 - 1) - (sl >> 31)).astype(jnp.int32)
        top_pos = (sl & jnp.int64(2**31 - 1)).astype(jnp.int32)
        gbest = (jnp.int64(2**31 - 1) - (pk_s[:, 0] >> 31)).astype(
            jnp.int32
        )
        gsecond = (jnp.int64(2**31 - 1) - (pk_s[:, 1] >> 31)).astype(
            jnp.int32
        )
    top_key = jnp.take_along_axis(keys_s, top_pos, axis=1)
    valid = top_cnt > 0

    if page is None:
        best = top_cnt[:, 0].astype(jnp.float32)
        second = jnp.where(valid[:, 1], top_cnt[:, 1], 0).astype(
            jnp.float32
        )
    else:
        best = gbest.astype(jnp.float32)
        second = jnp.where(gsecond > 0, gsecond, 0).astype(jnp.float32)
    is_fine = best < cfg.score_ratio * second
    min_score = best / cfg.score_ratio

    return CandidateBatch(
        win_id=jnp.where(valid, (top_key % BIGW).astype(jnp.int32), 0),
        is_rev=jnp.where(valid, top_key >= BIGW, False),
        cnt=jnp.where(valid, top_cnt, 0),
        valid=valid,
        is_fine=is_fine,
        min_score=min_score,
    )

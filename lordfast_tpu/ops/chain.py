"""Per-window seed selection + chaining DP (device).

``select_window_seeds`` mirrors the seed filtering of calcChainScore /
alignWin (src/LordFAST.cpp:659-680, 995-1018): window [w*rl, (w+2)*rl-1],
margin rl/2, clamped to the contig that contains the window midpoint.
Seeds are pre-sorted by (strand, tPos) once per read so each window's
seed set is a contiguous range found by binary search — the same set the
reference gathers by scanning the whole seed list per window.

``chain_dpn2`` is the O(n^2) chaining DP of chain_seeds_n2
(src/Chain.cpp:232-310) as a lax.scan over seeds (sequential in i,
vectorized over windows and j): reward = chainReward * MIN_ANCHOR_LEN,
penalty = 0.1*d + chainPenalty*log(d) with d = |distR - distT|
(src/Chain.cpp:211-225), float64 like the reference's double dp[].
Tie-breaking matches the reference exactly: predecessor = largest j among
score ties (the reference scans j descending with strict >), best chain
end = smallest i among ties (ascending scan with strict >).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class WindowSeeds(NamedTuple):
    q_pos: jnp.ndarray   # (..., N) int32, sorted by (qPos, tPos)
    t_pos: jnp.ndarray   # (..., N) position dtype
    length: jnp.ndarray  # (..., N) int32
    valid: jnp.ndarray   # (..., N) bool
    n_in_range: jnp.ndarray  # (...,) int32: seeds in range before the N cap


class ChainBatch(NamedTuple):
    q_pos: jnp.ndarray   # (..., N) chain seeds, ascending qPos
    t_pos: jnp.ndarray
    length: jnp.ndarray
    chain_len: jnp.ndarray  # (...,) int32
    score: jnp.ndarray      # (...,) float32 (-1 when no seeds, Chain.cpp:62)


class CompactWindows(NamedTuple):
    """Flat list of the windows that actually need chaining: the single
    top-vote window for coarse-mode reads (src/LordFAST.cpp:543-548) and
    every candidate above minScore for fine-mode reads (:875).  Compaction
    shrinks the chaining DP workload by roughly C_max / avg-needed."""

    read_idx: jnp.ndarray  # (K,) int32 index into the batch
    cand_idx: jnp.ndarray  # (K,) int32 index into the CandidateBatch row
    win_id: jnp.ndarray    # (K,) int32
    is_rev: jnp.ndarray    # (K,) bool
    valid: jnp.ndarray     # (K,) bool
    n_needed: jnp.ndarray  # () int32: true count (may exceed K: overflow)


def compact_candidates(cands, cfg, k_windows: int) -> CompactWindows:
    B, C = cands.cnt.shape
    cidx = jnp.arange(C, dtype=jnp.int32)[None, :]
    fine = cands.is_fine[:, None]
    need = cands.valid & jnp.where(
        fine,
        cands.cnt.astype(jnp.float32) > cands.min_score[:, None],
        cidx == 0,
    )
    flat_need = need.reshape(-1)
    key = jnp.where(flat_need, cands.cnt.reshape(-1), -1)
    val, pos = jax.lax.top_k(key, k_windows)
    ok = val > 0
    b = (pos // C).astype(jnp.int32)
    c = (pos % C).astype(jnp.int32)
    return CompactWindows(
        read_idx=jnp.where(ok, b, 0),
        cand_idx=jnp.where(ok, c, 0),
        win_id=jnp.where(ok, cands.win_id[b, c], 0),
        is_rev=jnp.where(ok, cands.is_rev[b, c], False),
        valid=ok,
        n_needed=flat_need.sum().astype(jnp.int32),
    )


def select_window_seeds(seeds, cw: CompactWindows, read_lens, arrs, cfg,
                        n_sel=None):
    """Gather each compacted window's seeds into fixed-size slots.

    Window geometry and seed filter follow calcChainScore / alignWin
    (src/LordFAST.cpp:659-680, 995-1018): [w*rl, (w+2)*rl-1] +- rl/2,
    clamped to the contig containing the window midpoint."""
    B, MS = seeds.t_pos.shape
    K = cw.read_idx.shape[0]
    N = n_sel or cfg.max_chain_seeds
    pdt = seeds.t_pos.dtype

    # one composite-key sort per read: (strand, tPos); the original slot
    # index rides along — it is the reference's seed-LIST position
    # (anchors in sample order, occurrences in SA-row order), which
    # decides equal-qPos ordering in the DP below
    BIGP = jnp.int64(2**40)
    key = jnp.where(
        seeds.valid,
        seeds.is_rev.astype(jnp.int64) * BIGP + seeds.t_pos.astype(jnp.int64),
        jnp.int64(2**62),
    )
    sidx0 = jnp.broadcast_to(jnp.arange(MS, dtype=jnp.int32)[None, :],
                             (B, MS))
    key_s, t_s, q_s, l_s, x_s = jax.lax.sort(
        (key, seeds.t_pos, seeds.q_pos, seeds.length, sidx0), num_keys=1
    )

    rb = cw.read_idx  # (K,)
    rl = read_lens.astype(jnp.int64)[rb]  # (K,)
    w = cw.win_id.astype(jnp.int64)
    t_start = w * rl
    t_end = (w + 2) * rl - 1
    margin = rl >> 1
    mid = (t_start + t_end) >> 1
    # contig of the midpoint (bns_pos2rid binary search, src/BWT.cpp:646)
    offs = arrs["contig_offsets"].astype(jnp.int64)
    ends = arrs["contig_ends"].astype(jnp.int64)
    rid = jnp.clip(
        jnp.searchsorted(offs, mid, side="right") - 1, 0, offs.shape[0] - 1
    )
    chr_beg = offs[rid]
    chr_end = ends[rid] - 1
    lo = jnp.maximum(t_start - margin, chr_beg)  # (K,)
    hi = jnp.minimum(t_end + margin, chr_end)

    strand = cw.is_rev.astype(jnp.int64)
    lo_key = strand * BIGP + lo
    hi_key = strand * BIGP + hi
    keys_per_win = key_s[rb]  # (K, MS)
    lo_idx = jax.vmap(
        lambda ks, q: jnp.searchsorted(ks, q, side="left")
    )(keys_per_win, lo_key[:, None])[:, 0]
    hi_idx = jax.vmap(
        lambda ks, q: jnp.searchsorted(ks, q, side="right")
    )(keys_per_win, hi_key[:, None])[:, 0]
    n_in_range = jnp.where(cw.valid, (hi_idx - lo_idx).astype(jnp.int32), 0)

    slot = jnp.arange(N)
    gidx = jnp.clip(lo_idx[:, None] + slot[None, :], 0, MS - 1)  # (K, N)
    ok = slot[None, :] < jnp.minimum(n_in_range, N)[:, None]

    q = jnp.where(ok, q_s[rb[:, None], gidx], 0)
    t = jnp.where(ok, t_s[rb[:, None], gidx], 0)
    ln = jnp.where(ok, l_s[rb[:, None], gidx], 0)
    so = jnp.where(ok, x_s[rb[:, None], gidx], 0)

    # sort window seeds by (qPos, seed-list position) for the DP: the
    # reference std::sort's by qPos only (src/Chain.cpp:244), and for
    # the window sizes where exact score ties actually occur (< 16
    # seeds) libstdc++ runs insertion sort — STABLE — so equal-qPos
    # seeds keep their seed-list order.  tPos order here demonstrably
    # flips equal-score chain ties (1600-copy paging stress test).
    BIGQ = jnp.int64(2**31)
    skey = jnp.where(ok, q.astype(jnp.int64) * BIGQ + so.astype(jnp.int64),
                     jnp.int64(2**62))
    sk, q2, t2, l2, ok2 = jax.lax.sort(
        (skey, q.astype(jnp.int32), t, ln.astype(jnp.int32),
         ok.astype(jnp.int32)),
        num_keys=1,
    )
    return WindowSeeds(
        q_pos=q2,
        t_pos=t2.astype(pdt),
        length=l2,
        valid=ok2 == 1,
        n_in_range=n_in_range,
    )


def _dp_dtype(cfg):
    mode = getattr(cfg, "chain_dp_dtype", "auto")
    if mode == "f64":
        return jnp.float64
    if mode == "f32":
        return jnp.float32
    # auto: f64 everywhere (native on the GPU and the CPU).  f64 scores
    # match the reference's double DP up to the backend's f64 log versus
    # libm, against f32's 1e-7, which demonstrably flips score-tied
    # windows.
    return jnp.float64


def _finish_chains(ws, dp, prev, q, t, ln, ok, lead, W, N) -> ChainBatch:
    """Shared epilogue for the chaining DPs: pick the best chain end
    (smallest index among score ties, matching the reference's ascending
    scan with strict >, src/Chain.cpp:289-293), backtrack through prev[],
    and emit the chain in ascending-qPos order."""
    jidx = jnp.arange(N, dtype=jnp.int32)
    best_score = jnp.max(dp, axis=1)
    any_ok = jnp.any(ok, axis=1)
    best_i = jnp.argmax(dp == best_score[:, None], axis=1).astype(jnp.int32)

    # backtrack (reversed), then flip to ascending qPos
    def bt_cond(state):
        cur, k, _ = state
        return jnp.any(cur >= 0)

    def bt_body(state):
        cur, k, out = state
        act = cur >= 0
        out = out.at[jnp.arange(W), k].set(jnp.where(act, cur, -1))
        nxt = jnp.where(act, prev[jnp.arange(W), jnp.maximum(cur, 0)], -1)
        k = k + act.astype(jnp.int32)
        return nxt, k, out

    out0 = jnp.full((W, N), -1, jnp.int32)
    cur0 = jnp.where(any_ok, best_i, -1)
    _, clen, rev_idx = jax.lax.while_loop(
        bt_cond, bt_body, (cur0, jnp.zeros(W, jnp.int32), out0)
    )

    # chain[j] = rev_idx[clen-1-j]
    pos = jnp.clip(clen[:, None] - 1 - jidx[None, :], 0, N - 1)
    cidx = jnp.take_along_axis(rev_idx, pos, axis=1)
    cvalid = jidx[None, :] < clen[:, None]
    cidx = jnp.clip(cidx, 0, N - 1)

    gq = jnp.where(cvalid, jnp.take_along_axis(q, cidx, 1), 0)
    gt = jnp.where(cvalid, jnp.take_along_axis(t, cidx, 1), 0)
    gl = jnp.where(cvalid, jnp.take_along_axis(ln, cidx, 1), 0)

    score = jnp.where(any_ok, best_score, -1.0).astype(jnp.float32)
    return ChainBatch(
        q_pos=gq.reshape(*lead, N),
        t_pos=gt.reshape(*lead, N).astype(ws.t_pos.dtype),
        length=gl.reshape(*lead, N),
        chain_len=jnp.where(any_ok, clen, 0).reshape(lead),
        score=score.reshape(lead),
    )


def _flatten_ws(ws):
    lead = ws.q_pos.shape[:-1]
    N = ws.q_pos.shape[-1]
    W = int(np.prod(lead)) if lead else 1
    q = ws.q_pos.reshape(W, N).astype(jnp.int32)
    t = ws.t_pos.reshape(W, N).astype(jnp.int64)
    ln = ws.length.reshape(W, N).astype(jnp.int32)
    ok = ws.valid.reshape(W, N)
    return lead, N, W, q, t, ln, ok


def chain_seeds(ws: WindowSeeds, cfg) -> ChainBatch:
    """Dispatch on cfg.chain_alg (--chainAlg, src/CommandLineParser.cpp:216;
    call sites src/LordFAST.cpp:1030-1050,1119-1135)."""
    from ..config import ChainAlg

    fn = (chain_clasp_sop if cfg.chain_alg == ChainAlg.CLASP
          else chain_dpn2)
    return _chain_bucketed(ws, cfg, fn)


def _tree_map_ws(ws: WindowSeeds, f) -> WindowSeeds:
    return WindowSeeds(
        q_pos=f(ws.q_pos), t_pos=f(ws.t_pos), length=f(ws.length),
        valid=f(ws.valid), n_in_range=ws.n_in_range,
    )


def _chain_bucketed(ws: WindowSeeds, cfg, dp_fn) -> ChainBatch:
    """Route windows to a narrow or wide chaining DP by seed count.

    The O(n^2) DP costs N^2 per window at the padded width N
    (= cfg.max_chain_seeds, 512), but most windows hold far fewer seeds
    (their valid seeds occupy the first slots: select_window_seeds sorts
    invalid entries to the end).  Run a cheap N_small-wide DP over EVERY
    window plus the full-width DP over only the top `big_k` windows by
    seed count; merge.  Both kernels are the exact same DP, so results
    are identical to the unbucketed version wherever each is complete —
    and a lax.cond falls back to the full DP for the whole batch in the
    (pathological) case that more than big_k windows exceed N_small.
    ~7x less DP work at bench shapes (1024 windows x 512 slots)."""
    lead = ws.q_pos.shape[:-1]
    N = ws.q_pos.shape[-1]
    NS = min(getattr(cfg, "chain_small_n", 64), N)
    if len(lead) != 1 or N <= NS:
        return dp_fn(ws, cfg)
    W = lead[0]
    big_k = min(getattr(cfg, "chain_big_windows", 128), W)
    count = ws.valid.sum(axis=-1).astype(jnp.int32)

    small = dp_fn(_tree_map_ws(ws, lambda a: a[:, :NS]), cfg)
    _, bigsel = jax.lax.top_k(count, big_k)
    big = dp_fn(_tree_map_ws(ws, lambda a: a[bigsel]), cfg)

    def merged(_):
        pad = [(0, 0), (0, N - NS)]
        out = ChainBatch(
            q_pos=jnp.pad(small.q_pos, pad),
            t_pos=jnp.pad(small.t_pos, pad),
            length=jnp.pad(small.length, pad),
            chain_len=small.chain_len,
            score=small.score,
        )
        return ChainBatch(
            q_pos=out.q_pos.at[bigsel].set(big.q_pos),
            t_pos=out.t_pos.at[bigsel].set(big.t_pos),
            length=out.length.at[bigsel].set(big.length),
            chain_len=out.chain_len.at[bigsel].set(big.chain_len),
            score=out.score.at[bigsel].set(big.score),
        )

    covered = (count > NS).sum() <= big_k
    return jax.lax.cond(covered, merged, lambda _: dp_fn(ws, cfg), None)


def chain_dpn2(ws: WindowSeeds, cfg) -> ChainBatch:
    lead, N, W, q, t, ln, ok = _flatten_ws(ws)
    fdt = _dp_dtype(cfg)

    reward = jnp.asarray(cfg.chain_reward * cfg.min_anchor_len, fdt)
    jidx = jnp.arange(N, dtype=jnp.int32)

    q_end = q + ln - 1  # qPos_j + len_j - 1
    t_end = t + ln - 1

    def step(carry, i):
        dp, prev = carry
        dist_r = q[:, i][:, None] - q_end  # (W, N)
        dist_t = (t[:, i][:, None] - t_end).astype(jnp.int32)
        can = ok & (jidx[None, :] < i) & (dist_r > 0) & (dist_t > 0)
        d = jnp.abs(dist_r - dist_t)
        pen = jnp.where(
            d <= 1,
            jnp.asarray(0.0, fdt),
            0.1 * d.astype(fdt)
            + cfg.chain_penalty * jnp.log(jnp.maximum(d, 2).astype(fdt)),
        )
        val = jnp.where(can, dp + reward - pen, -jnp.inf)
        base = ln[:, i].astype(fdt)
        best = jnp.max(val, axis=1)
        take = best > base  # strict, like dp[j]+a-b > dp[i] (Chain.cpp:275)
        # predecessor: largest j among ties (reference scans j descending
        # with strict >)
        is_best = val == best[:, None]
        pj = jnp.max(jnp.where(is_best, jidx[None, :], -1), axis=1)
        dp_i = jnp.where(take, best, base)
        prev_i = jnp.where(take, pj, -1)
        dp = dp.at[:, i].set(jnp.where(ok[:, i], dp_i, -jnp.inf))
        prev = prev.at[:, i].set(jnp.where(ok[:, i], prev_i, -1))
        return (dp, prev), None

    dp0 = jnp.full((W, N), -jnp.inf, fdt)
    prev0 = jnp.full((W, N), -1, jnp.int32)
    (dp, prev), _ = jax.lax.scan(step, (dp0, prev0), jnp.arange(N),
                                 unroll=8)
    return _finish_chains(ws, dp, prev, q, t, ln, ok, lead, W, N)


def chain_clasp_sop(ws: WindowSeeds, cfg) -> ChainBatch:
    """clasp sum-of-pairs local chaining (chain_seeds_clasp,
    src/Chain.cpp:39-209 -> bl_slClusterSop/bl_slChainSop,
    lib/clasp/slchain.c:568-828), reimplemented as a masked O(n^2) DP —
    SURVEY.md §2.4: the sweep-line + layered range tree is the reference's
    *data structure*; the chaining semantics are the spec.

    Semantics (lib/clasp/slchain.h:29-56):
      fragment score   scr = len                       (src/Chain.cpp:71-76)
      precedence       FEND_S(j) < FSTART_S(i) and FEND_Q(j) < FSTART_Q(i)
                       (strict, both axes — octants O_1/O_2 of Abouelhoda)
      gap cost  GSOP(i,j) = lambda*max(DX,DY) + (eps-lambda)*min(DX,DY),
                DX = tStart_i - tEnd_j - 1, DY = qStart_i - qEnd_j - 1
      chain score      dp[i] = scr_i + max_j(dp[j] - GSOP(i,j))
      local reset      predecessor dropped when dp[j] < GSOP (slchain.c:719)
      defaults         eps=0, lambda=0.15, maxgap off (src/Chain.cpp:52-55)
    Deterministic tie-breaks (the reference's depend on malloc'd tree
    layout): predecessor = largest j among ties; chain end = smallest i.
    """
    lead, N, W, q, t, ln, ok = _flatten_ws(ws)
    fdt = _dp_dtype(cfg)
    lam = jnp.asarray(cfg.clasp_lambda, fdt)
    eps = jnp.asarray(cfg.clasp_epsilon, fdt)
    jidx = jnp.arange(N, dtype=jnp.int32)

    q_end = q + ln - 1
    t_end = t + ln - 1
    scr = ln.astype(fdt)

    def step(carry, i):
        dp, prev = carry
        dy = q[:, i][:, None] - q_end - 1        # (W, N) DY
        dx = (t[:, i][:, None] - t_end - 1).astype(jnp.int32)
        can = ok & (jidx[None, :] < i) & (dy >= 0) & (dx >= 0)
        dxf = dx.astype(fdt)
        dyf = dy.astype(fdt)
        gsop = lam * jnp.maximum(dxf, dyf) + (eps - lam) * jnp.minimum(
            dxf, dyf
        )
        val = jnp.where(can, dp - gsop, -jnp.inf)
        best = jnp.max(val, axis=1)
        # local chaining: keep the link only while dp[j] >= GSOP (strict <
        # drops it, slchain.c:717-721) i.e. best >= 0
        take = best >= 0
        is_best = val == best[:, None]
        pj = jnp.max(jnp.where(is_best, jidx[None, :], -1), axis=1)
        dp_i = scr[:, i] + jnp.maximum(best, 0.0)
        prev_i = jnp.where(take, pj, -1)
        dp = dp.at[:, i].set(jnp.where(ok[:, i], dp_i, -jnp.inf))
        prev = prev.at[:, i].set(jnp.where(ok[:, i], prev_i, -1))
        return (dp, prev), None

    dp0 = jnp.full((W, N), -jnp.inf, fdt)
    prev0 = jnp.full((W, N), -1, jnp.int32)
    (dp, prev), _ = jax.lax.scan(step, (dp0, prev0), jnp.arange(N),
                                 unroll=8)
    return _finish_chains(ws, dp, prev, q, t, ln, ok, lead, W, N)

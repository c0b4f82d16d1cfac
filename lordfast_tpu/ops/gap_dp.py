"""Batched device gap-DP: Myers bit-parallel NW / SHW edit-distance
alignment with full path traceback, over padded gap buckets.

This is the device equivalent of the reference's #1 hot loop — ``edlibAlign``
called once per inter-seed gap and read end during chain stitching
(reference: src/LordFAST.cpp:1833,1941,2168; Myers block update
lib/edlib/edlib.cpp:335-470, NW/SHW drivers :475-870).  The host
equivalents live in native/align_eq.cpp (``nw_align`` / ``shw_best_end``);
they are the byte-exactness oracle for this kernel.

Design (SURVEY.md §7 step 5):

- Every gap of a batch (inter-seed NW gaps + SHW end extensions, across
  all reads x selected windows) is gathered into one padded
  ``(G, Q)/(G, T)`` code tensor per size bucket.
- One ``lax.scan`` over the T target columns advances the bit-parallel
  state for all G gaps in lockstep.  Each column does a tiny inner scan
  over the W = Q/32 query words, chaining the horizontal delta (hin/hout)
  exactly like edlib's ``calculateBlock`` — the DP cell values (hence all
  outputs) are exact integers, identical to the scalar oracle for any
  word size.
- Fill-time decision bitplanes: the traceback decision at cell (r, c)
  under the oracle's move priority (UP i.e. consume-query, then LEFT
  i.e. consume-target, then diagonal) is a pure function of the delta
  bits: UP iff the vertical delta of column c at row r is +1 (PvOut bit),
  else LEFT iff the horizontal delta at row r is +1 (pre-shift Ph bit).
  Both planes are emitted per column, so traceback needs no score
  reconstruction at all.
- Traceback is a masked ``lax.while_loop`` walking all G gaps in
  lockstep from their (ql-1, end) corners, emitting edlib-convention
  moves (0=match 1=insert/consume-query 2=delete/consume-target
  3=mismatch), then reversing per gap.
- Moves are packed 16-per-uint32 for the host transfer (the gap results
  downlink is ~(Q+T)/16 words per gap).

SHW reproduces the edlib negative-end artifact of the oracle
(native/align_eq.cpp shw_best_end): with W64 = (64 - ql % 64) % 64, the
virtual position -1 scores ``min(ql, min_{1<=j<=min(W64,tl)} d_j + j)``
and wins ties, in which case end = -1 and the path is ql insertions.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# move codes (edlib convention, matching native/align_eq.cpp)
OP_MATCH, OP_INSERT, OP_DELETE, OP_MISMATCH = 0, 1, 2, 3

INT32_MAX = np.int32(2**31 - 1)


class GapResult(NamedTuple):
    dist: jnp.ndarray          # (G,) int32
    end: jnp.ndarray           # (G,) int32 (SHW best end / -1; NW: tl-1)
    moves_packed: jnp.ndarray  # (G, (Q+T)//16) uint32, 2 bits per move
    mlen: jnp.ndarray          # (G,) int32


def _build_peq(qs: jnp.ndarray, Q: int, W: int) -> jnp.ndarray:
    """(G, 5, W) uint32 match masks: bit r of Peq[g, c, w] == 1 iff
    qs[g, w*32 + r] == c.  Padding rows (>= ql) never matter: within a
    word, carries propagate low->high bit only, and the padding rows sit
    above every valid row."""
    G = qs.shape[0]
    eq = qs[:, None, :] == jnp.arange(5, dtype=qs.dtype)[None, :, None]
    eq = eq.reshape(G, 5, W, 32).astype(jnp.uint32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    return (eq * weights[None, None, None, :]).sum(axis=-1,
                                                   dtype=jnp.uint32)


def _advance_column(Pv, Mv, Eq, W):
    """One Myers column over W chained words (edlib calculateBlock,
    lib/edlib/edlib.cpp:334-369, with 32-bit words).  Returns
    (PvOut, MvOut, Ph_pre, Mh_pre): the output delta words plus the
    pre-shift horizontal delta words (decision/score bits).
    All arrays (G, W) uint32; the boundary hin is +1 (top boundary row
    D(-1, c) = c in both NW and SHW modes, native/align_eq.cpp:68,151)."""
    G = Pv.shape[0]
    one = jnp.uint32(1)

    def word_step(hin, xs):
        pv, mv, eq = xs  # (G,)
        hin_neg = jnp.where(hin < 0, one, jnp.uint32(0))
        xv = eq | mv
        eq2 = eq | hin_neg
        xh = (((eq2 & pv) + pv) ^ pv) | eq2
        ph = mv | ~(xh | pv)
        mh = pv & xh
        hout = ((ph >> 31) & one).astype(jnp.int32) - (
            (mh >> 31) & one
        ).astype(jnp.int32)
        ph_s = (ph << 1) | jnp.where(hin > 0, one, jnp.uint32(0))
        mh_s = (mh << 1) | hin_neg
        pv_out = mh_s | ~(xv | ph_s)
        mv_out = ph_s & xv
        return hout, (pv_out, mv_out, ph, mh)

    hin0 = jnp.ones((G,), jnp.int32)
    xs = (Pv.T, Mv.T, Eq.T)  # (W, G)
    _, (pv_o, mv_o, ph_pre, mh_pre) = jax.lax.scan(word_step, hin0, xs)
    return pv_o.T, mv_o.T, ph_pre.T, mh_pre.T


@functools.partial(jax.jit, static_argnums=(5, 6))
def gap_align(qs, ql, ts, tl, is_shw, Q: int, T: int) -> GapResult:
    """Batched NW/SHW edit-distance alignment with path.

    qs: (G, Q) uint8 query codes (0..4), rows >= ql arbitrary
    ql: (G,) int32, 1 <= ql <= Q
    ts: (G, T) uint8 target codes, cols >= tl arbitrary
    tl: (G,) int32, 1 <= tl <= T
    is_shw: (G,) bool — True: prefix mode (trailing target free);
            False: global NW.
    """
    assert Q % 32 == 0 and (Q + T) % 16 == 0
    G = qs.shape[0]
    W = Q // 32
    M = Q + T

    ql = ql.astype(jnp.int32)
    tl = tl.astype(jnp.int32)
    peq = _build_peq(qs, Q, W)
    garange = jnp.arange(G)

    bw = (ql - 1) >> 5          # (G,) word index of the bottom row
    bb = ((ql - 1) & 31).astype(jnp.uint32)
    w64 = (64 - (ql % 64)) % 64  # edlib WORD_SIZE=64 padding (artifact)
    neg1_cap = jnp.minimum(w64, tl)  # largest 1-based column in the term

    def column(carry, xs):
        Pv, Mv, score, dist, best, best_end, neg1 = carry
        tchar, c = xs  # (G,) uint8, () int32
        eq = jnp.take_along_axis(
            peq, tchar.astype(jnp.int32)[:, None, None], axis=1
        )[:, 0]  # (G, W)
        Pv2, Mv2, ph_pre, mh_pre = _advance_column(Pv, Mv, eq, W)
        ph_bit = (ph_pre[garange, bw] >> bb) & jnp.uint32(1)
        mh_bit = (mh_pre[garange, bw] >> bb) & jnp.uint32(1)
        score = score + ph_bit.astype(jnp.int32) - mh_bit.astype(jnp.int32)
        dist = jnp.where(c == tl - 1, score, dist)
        in_range = c < tl
        upd = in_range & (score < best)
        best_end = jnp.where(upd, c, best_end)
        best = jnp.where(upd, score, best)
        j = c + 1  # 1-based column
        neg1 = jnp.where(
            in_range & (j <= neg1_cap), jnp.minimum(neg1, score + j), neg1
        )
        return (Pv2, Mv2, score, dist, best, best_end, neg1), (Pv2, ph_pre)

    Pv0 = jnp.full((G, W), jnp.uint32(0xFFFFFFFF))
    Mv0 = jnp.zeros((G, W), jnp.uint32)
    init = (
        Pv0, Mv0, ql.astype(jnp.int32),          # score = D(ql-1, -1) = ql
        jnp.full((G,), INT32_MAX), jnp.full((G,), INT32_MAX),
        jnp.full((G,), -2, jnp.int32),
        # the j = 0 term of position -1 is d_0 + 0 = ql (only when W64 >= 1)
        jnp.where(w64 >= 1, ql, INT32_MAX),
    )
    cols = jnp.arange(T, dtype=jnp.int32)
    (_, _, _, nw_dist, best, best_end, neg1), (up_pl, left_pl) = (
        jax.lax.scan(column, init, (ts.T, cols))
    )
    # up_pl/left_pl: (T, G, W) uint32 decision bitplanes

    # SHW resolution incl. the artifact and empty-target guards
    use_neg1 = (w64 >= 1) & (neg1 <= best)
    shw_dist = jnp.where(use_neg1, neg1,
                         jnp.where(best_end == -2, ql, best))
    shw_end = jnp.where(use_neg1 | (best_end == -2), -1, best_end)
    dist = jnp.where(is_shw, shw_dist, nw_dist)
    end = jnp.where(is_shw, shw_end, tl - 1)

    # ---- lockstep traceback ----
    up_flat = up_pl.reshape(-1)
    left_flat = left_pl.reshape(-1)

    def tb_cond(state):
        r, c, k, _ = state
        return jnp.any((r >= 0) | (c >= 0))

    def tb_body(state):
        r, c, k, moves = state
        active = (r >= 0) | (c >= 0)
        interior = (r >= 0) & (c >= 0)
        rs = jnp.maximum(r, 0)
        cs = jnp.maximum(c, 0)
        widx = (cs * G + garange) * W + (rs >> 5)
        rbit = (rs & 31).astype(jnp.uint32)
        up_b = ((up_flat[widx] >> rbit) & jnp.uint32(1)) == 1
        left_b = ((left_flat[widx] >> rbit) & jnp.uint32(1)) == 1
        qch = qs[garange, rs]
        tch = ts[garange, cs]
        diag_mv = jnp.where(qch == tch, OP_MATCH, OP_MISMATCH).astype(
            jnp.uint8
        )
        go_up = (interior & up_b) | ((r >= 0) & (c < 0))
        go_left = (~go_up) & ((interior & left_b) | ((c >= 0) & (r < 0)))
        go_diag = interior & ~go_up & ~go_left
        mv = jnp.where(
            go_up, jnp.uint8(OP_INSERT),
            jnp.where(go_left, jnp.uint8(OP_DELETE), diag_mv),
        )
        wpos = jnp.where(active, k, M)  # M = trash column
        moves = moves.at[garange, wpos].set(mv)
        r = r - (go_up | go_diag).astype(jnp.int32)
        c = c - (go_left | go_diag).astype(jnp.int32)
        k = k + active.astype(jnp.int32)
        return r, c, k, moves

    moves0 = jnp.zeros((G, M + 1), jnp.uint8)
    r0 = ql - 1
    c0 = end
    _, _, mlen, moves_rev = jax.lax.while_loop(
        tb_cond, tb_body, (r0, c0, jnp.zeros(G, jnp.int32), moves0)
    )

    # reverse each gap's moves into forward order and pack 16/uint32
    pos = jnp.arange(M, dtype=jnp.int32)[None, :]
    src = jnp.clip(mlen[:, None] - 1 - pos, 0, M)
    fwd = jnp.where(
        pos < mlen[:, None],
        jnp.take_along_axis(moves_rev, src, axis=1)[:, :M],
        0,
    ).astype(jnp.uint32)
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    packed = (fwd.reshape(G, M // 16, 16) << shifts).sum(
        axis=-1, dtype=jnp.uint32
    )
    return GapResult(dist=dist, end=end, moves_packed=packed, mlen=mlen)


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def gather_gap_seqs_jit(pac_words, reads, desc, Q: int, T: int,
                        l_pac: int):
    """Jitted gather alone — letting the engine dispatch gather (which
    recompiles per read-batch shape, cheap) separately from the DP
    kernel (which then compiles once per (Q, T) bucket, expensive)."""
    return gather_gap_seqs(pac_words, reads, desc, Q, T, l_pac)


def gather_gap_seqs(pac_words, reads, desc, Q: int, T: int, l_pac: int):
    """Device gather of the (qs, ql, ts, tl) padded code tensors for a gap
    descriptor table — feeds the jnp kernel (gap_align) and the Pallas
    kernel (ops/gap_dp_pallas.py).  See gap_align_from_desc for the
    descriptor semantics."""
    G = desc["q_read"].shape[0]
    ql = jnp.maximum(jnp.where(desc["valid"], desc["q_len"], 1), 1)
    tl = jnp.maximum(jnp.where(desc["valid"], desc["t_len"], 1), 1)

    j_q = jnp.arange(Q, dtype=jnp.int32)[None, :]
    qpos = jnp.where(
        desc["q_rc"][:, None],
        desc["q_start"][:, None] + ql[:, None] - 1 - j_q,
        desc["q_start"][:, None] + j_q,
    )
    q_ok = (j_q < ql[:, None]) & (qpos >= 0) & (qpos < reads.shape[1])
    qg = reads[desc["q_read"][:, None], jnp.clip(qpos, 0, reads.shape[1] - 1)]
    qg = jnp.where(desc["q_rc"][:, None] & (qg < 4), 3 - qg, qg)
    qs = jnp.where(q_ok, qg, 4).astype(jnp.uint8)

    # Target fetch in two steps: (1) gather the CONTIGUOUS word rows
    # covering [t_start, t_start+T) — T/16+1 words per gap — and unpack
    # them into a small local code window; (2) per-element indexing
    # (incl. the t_rc reversal) against that window.  A direct
    # per-element gather over pac_words costs ~16x more HBM transactions
    # and dominates gap-DP time at Gbp scale (pac_words is 1.5 GB for
    # GRCh38; the window buffer is (G, T+16) bytes).
    NWt = T // 16 + 1
    t0 = desc["t_start"].astype(jnp.int64)
    base = jnp.clip(t0, 0, None) >> 4
    max_row = (2 * l_pac - 1) >> 4
    rows = jnp.clip(base[:, None] + jnp.arange(NWt, dtype=jnp.int64),
                    0, max_row)
    twords = pac_words[rows]                       # (G, NWt) u32
    sh16 = (jnp.uint32(2) * (15 - jnp.arange(16, dtype=jnp.uint32)))
    win = ((twords[:, :, None] >> sh16[None, None, :]) & 3).astype(
        jnp.uint8).reshape(-1, NWt * 16)           # (G, NWt*16)

    j_t = jnp.arange(T, dtype=jnp.int64)[None, :]
    tpos = jnp.where(
        desc["t_rc"][:, None],
        t0[:, None] + tl.astype(jnp.int64)[:, None] - 1 - j_t,
        t0[:, None] + j_t,
    )
    t_in = (tpos >= 0) & (tpos < l_pac)
    widx = jnp.clip(tpos - (base[:, None] << 4), 0, NWt * 16 - 1)
    tg = jnp.take_along_axis(win, widx.astype(jnp.int32), axis=1)
    tg = jnp.where(t_in, tg, 0)          # pad 0 like get_ref_codes
    tg = jnp.where(desc["t_rc"][:, None], 3 - tg, tg)
    ts = jnp.where(j_t < tl[:, None], tg, 0).astype(jnp.uint8)
    return qs, ql.astype(jnp.int32), ts, tl.astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def gap_align_from_desc(pac_words, reads, desc, Q: int, T: int,
                        l_pac: int) -> GapResult:
    """Gather gap sequences on device from the resident read batch and the
    packed genome, then run the batched Myers alignment.

    The host never uploads sequence data for gaps — only the descriptor
    table (a few int32/int64 per gap); reads were already shipped for
    seeding and the genome lives on device (index/container.py pac_words).

    desc: dict of (G,) arrays —
      q_read  int32   row into ``reads``
      q_start int32   query slice start (pre-reversal coordinates)
      q_len   int32   query length (>= 1 for valid gaps)
      q_rc    bool    reverse-complement the query slice
      t_start int64   global target start (pre-reversal coordinates)
      t_len   int32   target length (>= 1)
      t_rc    bool    reverse-complement the target slice
      is_shw  bool    prefix mode
      valid   bool    inactive rows are aligned as (1,1) dummies

    Semantics of the gathers match the host stitcher exactly: query codes
    come from the strand-oriented read row; target codes from the forward
    genome with out-of-range positions reading 0 ('A')
    (index/container.py get_ref_codes padding), reverse-complement applied
    after slicing (chain_align.py _rc)."""
    qs, ql, ts, tl = gather_gap_seqs(pac_words, reads, desc, Q, T, l_pac)
    return gap_align(qs, ql, ts, tl, desc["is_shw"], Q, T)


def unpack_moves(packed: np.ndarray, mlen: np.ndarray) -> list:
    """Host-side: (G, M/16) uint32 -> list of (mlen_g,) uint8 move arrays."""
    G, nw = packed.shape
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    all_mv = ((packed[:, :, None] >> shifts) & 3).astype(np.uint8)
    all_mv = all_mv.reshape(G, nw * 16)
    return [all_mv[g, : int(mlen[g])] for g in range(G)]

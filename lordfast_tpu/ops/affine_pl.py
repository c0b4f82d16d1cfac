"""Batched affine-gap extension (ksw_extend2 semantics) in plain
jax.numpy / lax — the device path for the clip / split escalation DPs.

Reference semantics: lib/bwa/ksw.c:380-479 (banded, z-drop, end-bonus
extension).  The byte-exactness oracle is the host scalar port
native/align_eq.cpp sw_extend (itself golden-tested), wrapped as
align.edlib_eq.ksw_extend2.  Only scores and end positions are produced
(the reference returns no path; callers re-run the Myers NW on the
trimmed segments — src/LordFAST.cpp:1850,1998 — which the batched Myers
kernel already covers).

Why no hand-written kernel: it runs only at escalation sites (SV / clip
reads), and every row is a handful of whole-band vector ops that XLA
fuses; a `lax.while_loop` over target rows on (BW, G) arrays is the
whole implementation.

Design: band slots on axis 0, one column per extension problem.
- The DP runs in band-relative coordinates: at target row i, band slot k
  holds query column j = i - w_max + k.  The diagonal predecessor then
  lives in the SAME slot (the scalar code keeps H shifted by one column,
  ksw.c:424's h1 dance), E shifts up one slot per row, and the query
  band shifts up with a single shared-index row fill — no per-problem
  gathers anywhere.
- The F (query-gap) chain, scalar-sequential in ksw.c:441-447, has the
  closed form F_j = max_{k<j}(max(M_k - oe_ins, 0) + k e_ins) - (j-1) e_ins
  — an exclusive prefix-max along the band (log2(BW) shifted maxes).
- The adaptive interval [beg, end) (band clamp + dead-cell shrink,
  ksw.c:414-421,466-469) is tracked per problem; the shrink scans become
  masked min/max reductions.  Exactness notes: the dead-cell shrink is
  lossless (cells it cuts are provably zero and F cannot leak into a
  dead region because h >= f >= 0 at the boundary), so a masked dense
  band reproduces the scalar values; the h0-decay first row, the
  frontier H[end]=h1 / E[end]=0 writes, the beg==0 h1 rule, the
  latest-row gscore tie rule (including the empty-row j==qlen case), the
  LAST-j row-max tie rule (ksw.c:437 `mj = m > h? mj : j`), z-drop
  timing and the row_max==0 break are all replicated as masked updates.
- The loop stops at the first row where no problem is still active
  (every problem past its target end, z-dropped or dead); later rows
  could not change any output.
- Per-problem parameters (gap costs, band width, zdrop, h0, match /
  mismatch) are per-column vectors, so clip-mode (band 40) and
  split-mode (band 100) problems batch into one call.  The per-problem
  band width w_eff (after ksw.c:399-407's max_ins/max_del clamp,
  computed on the host in exact double arithmetic) may be smaller than
  the storage band w_max; masks handle the difference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

NEG_BIG = np.int32(-(1 << 30))
POS_BIG = np.int32(1 << 30)


class ExtendResult(NamedTuple):
    score: jnp.ndarray   # (G,) int32 best extension score (>= h0)
    qle: jnp.ndarray     # (G,) int32 query length of best cell (0 if none)
    tle: jnp.ndarray     # (G,) int32 target length of best cell
    gtle: jnp.ndarray    # (G,) int32 target length reaching the query end
    gscore: jnp.ndarray  # (G,) int32 best score reaching the query end
    max_off: jnp.ndarray  # (G,) int32 max diagonal offset of the best cell


def _roll_up(x, s, k_iota, BW, fill):
    """x shifted up by s band slots (slot k takes x[k+s]); vacated bottom
    slots get `fill`."""
    return jnp.where(k_iota < BW - s, jnp.roll(x, -s, axis=0), fill)


def _roll_down(x, s, k_iota, fill):
    """x shifted down by s band slots (slot k takes x[k-s])."""
    return jnp.where(k_iota >= s, jnp.roll(x, s, axis=0), fill)


def clamp_band(qlen, match_sc: int, end_bonus: int, o_del: int, e_del: int,
               o_ins: int, e_ins: int, w: int):
    """Band clamp by max possible #ins/#del (ksw.c:399-407), with the
    reference's exact double-arithmetic `+ 1.` truncation."""
    qlen = np.asarray(qlen, np.int64)
    max_ins = (qlen.astype(np.float64) * match_sc + end_bonus
               - o_ins) / e_ins + 1.0
    max_ins = np.maximum(max_ins.astype(np.int64), 1)
    max_del = (qlen.astype(np.float64) * match_sc + end_bonus
               - o_del) / e_del + 1.0
    max_del = np.maximum(max_del.astype(np.int64), 1)
    return np.minimum(np.minimum(w, max_ins), max_del).astype(np.int32)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def extend_batch(qs, ts, Qe: int, Te: int, BW: int, w_max: int,
                 qlen=None, tlen=None, o_del=None, e_del=None, o_ins=None,
                 e_ins=None, w_eff=None, zdrop=None, h0=None, match=None,
                 mismatch=None) -> ExtendResult:
    """Batched ksw_extend2.  qs: (G, Qe) uint8/int codes, ts: (G, Te);
    all per-problem parameters are (G,) int32 vectors.  w_eff must
    already include the max_ins/max_del clamp (use clamp_band) and be
    <= w_max (the static storage band)."""
    G = qs.shape[0]
    qs32 = jnp.asarray(qs).astype(jnp.int32).T   # (Qe, G)
    ts32 = jnp.asarray(ts).astype(jnp.int32).T   # (Te, G)
    row = lambda v: jnp.asarray(v).astype(jnp.int32).reshape(1, G)
    qlen, tlen = row(qlen), row(tlen)
    o_del, e_del, o_ins, e_ins = row(o_del), row(e_del), row(o_ins), \
        row(e_ins)
    w_eff, zdrop, h0 = row(w_eff), row(zdrop), row(h0)
    match, mismatch = row(match), row(mismatch)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    i0 = jnp.int32(0)
    i1 = jnp.int32(1)
    neg = jnp.int32(NEG_BIG)
    big = jnp.int32(POS_BIG)
    k_iota = jax.lax.broadcasted_iota(jnp.int32, (BW, G), 0)

    def init_decay(jcol):
        """Scalar init fill H[j] (shifted; value of column j-1):
        H[0]=h0; H[1]=max(h0-oe_ins,0); H[j]=max(H[1]-(j-1)e_ins,0)."""
        h1v = jnp.maximum(h0 - oe_ins, i0)
        return jnp.where(
            jcol <= 0, h0,
            jnp.maximum(h1v - (jcol - i1) * e_ins, i0),
        )

    def body(carry):
        (i, Hband, Eband, qband, beg, end, best, best_i, best_j,
         best_ie, gscore, moff, active) = carry
        act = (active != 0) & (i < tlen)
        t_i = jax.lax.dynamic_slice_in_dim(ts32, i, 1, 0)   # (1, G)
        j_mat = (i - w_max) + k_iota                       # (BW, G)
        # band clamp for this row (ksw.c:414-416)
        beg_r = jnp.maximum(beg, i - w_eff)
        end_r = jnp.minimum(jnp.minimum(end, i + w_eff + i1), qlen)
        in_band = (j_mat >= beg_r) & (j_mat < end_r)
        h1_init = jnp.where(
            beg_r == 0,
            jnp.maximum(h0 - (o_del + e_del * (i + i1)), i0),
            i0,
        )
        s = jnp.where(
            (qband >= 4) | (t_i >= 4), i0,
            jnp.where(qband == t_i, match, -mismatch),
        )
        M = jnp.where((Hband != 0) & in_band, Hband + s, i0)
        # F chain: exclusive prefix-max of A = max(M-oe_ins,0)+k*e_ins
        A = jnp.where(in_band,
                      jnp.maximum(M - oe_ins, i0) + k_iota * e_ins,
                      neg)
        inc = A
        sh = 1
        while sh < BW:
            inc = jnp.maximum(inc, _roll_down(inc, sh, k_iota, neg))
            sh *= 2
        p_excl = _roll_down(inc, 1, k_iota, neg)
        f = jnp.maximum(p_excl - (k_iota - i1) * e_ins, i0)
        h = jnp.maximum(jnp.maximum(M, Eband), f)
        h = jnp.where(in_band, h, i0)
        # row stats over the computed interval (scalar row_max starts
        # at 0; ksw.c:437 `mj = m > h? mj : j` moves row_max_j to the
        # LAST j achieving the running max, i.e. the last argmax)
        rm = jnp.max(h, axis=0, keepdims=True)
        rmj = jnp.max(
            jnp.where(in_band & (h == rm) & (rm > 0), j_mat,
                      jnp.int32(-1)),
            axis=0, keepdims=True,
        )
        # gscore: scalar checks `j == qlen` after the loop, where
        # j = end_r if the loop ran else beg_r, with h1 = h(i, end_r-1)
        # resp. h1_init (empty row)
        loop_ran = beg_r < end_r
        h_last = jnp.max(
            jnp.where(j_mat == end_r - 1, h, neg), axis=0,
            keepdims=True,
        )
        h_after = jnp.where(loop_ran, h_last, h1_init)
        reach = jnp.where(loop_ran, end_r, beg_r) == qlen
        gupd = act & reach & (h_after >= gscore)
        gscore = jnp.where(gupd, h_after, gscore)
        best_ie = jnp.where(gupd, i, best_ie)
        # break on dead row, then best / z-drop (ksw.c:451-461)
        brk0 = rm == 0
        imp = act & ~brk0 & (rm > best)
        moff = jnp.where(imp, jnp.maximum(moff, jnp.abs(rmj - i)),
                         moff)
        best = jnp.where(imp, rm, best)
        best_i = jnp.where(imp, i, best_i)
        best_j = jnp.where(imp, rmj, best_j)
        di = i - best_i
        dj = rmj - best_j
        del_side = di > dj
        zcond = (del_side
                 & (best - rm - (di - dj) * e_del > zdrop)) | (
            ~del_side & (best - rm - (dj - di) * e_ins > zdrop))
        brkz = ~imp & (zdrop > 0) & zcond
        active = jnp.where(act & ~brk0 & ~brkz, i1, i0)

        # ---- state for the next row ----
        # scalar H[j] for j in [beg_r, end_r] becomes h(i, j-1), with
        # h(i, beg_r-1) = h1_init; other slots keep their value.  In
        # next-row coordinates (j = i+1-w_max+k) the updated slots
        # coincide with this row's h at the same k; unchanged slots
        # roll up, the entering slot fills with the init decay.
        j_next = (i + i1 - w_max) + k_iota
        hrow_eff = jnp.where(j_mat == beg_r - 1, h1_init, h)
        upd_h = (j_next >= beg_r) & (j_next <= end_r)
        # the slot entering at k = BW-1 corresponds to column
        # (i+1) - w_max + (BW-1); it starts life as the init row
        # (never yet updated) — the invariant that keeps every slot
        # equal to the scalar arrays
        fill_col = i + i1 - w_max + jnp.int32(BW - 1)
        h_fill = jnp.where(fill_col <= qlen, init_decay(fill_col), i0)
        Hband = jnp.where(upd_h, hrow_eff,
                          _roll_up(Hband, 1, k_iota, BW, h_fill))

        # E: scalar E[j] for j in [beg_r, end_r) updated, E[end_r]=0,
        # else unchanged; next row reads one slot up -> roll up
        Erec = jnp.maximum(Eband - e_del,
                           jnp.maximum(M - oe_del, i0))
        Enew = jnp.where(in_band, Erec,
                         jnp.where(j_mat == end_r, i0, Eband))
        Eband = _roll_up(Enew, 1, k_iota, BW, i0)

        # query band roll + shared-index fill
        qcol = jnp.minimum(fill_col, jnp.int32(Qe - 1))
        q_fill_v = jax.lax.dynamic_slice_in_dim(qs32, qcol, 1, 0)
        q_fill = jnp.where(fill_col < qlen, q_fill_v, jnp.int32(4))
        qband = _roll_up(qband, 1, k_iota, BW, q_fill)

        # dead-cell shrink (ksw.c:466-469): forward scan over
        # [beg_r, end_r), backward scan over [beg2, end_r], on the
        # post-update arrays (now in next-row coordinates)
        nz = (Hband != 0) | (Eband != 0)
        m_f = (j_next >= beg_r) & (j_next < end_r)
        first_nz = jnp.min(jnp.where(m_f & nz, j_next, big), axis=0,
                           keepdims=True)
        beg2 = jnp.where(first_nz == POS_BIG, end_r, first_nz)
        m_b = (j_next >= beg2) & (j_next <= end_r)
        last_nz = jnp.max(jnp.where(m_b & nz, j_next, neg), axis=0,
                          keepdims=True)
        last_nz = jnp.where(last_nz == NEG_BIG, beg2 - 1, last_nz)
        end2 = jnp.minimum(last_nz + 2, qlen)
        beg = jnp.where(active != 0, beg2, beg)
        end = jnp.where(active != 0, end2, end)
        return (i + i1, Hband, Eband, qband, beg, end, best, best_i,
                best_j, best_ie, gscore, moff, active)

    # init: band slots hold the shifted init row H[j], j = -w_max + k,
    # and the query codes of those columns (4 = outside the query)
    j_init = (0 - w_max) + k_iota
    Hband0 = jnp.where((j_init >= 0) & (j_init <= qlen),
                       init_decay(j_init), i0)
    q0 = jnp.take_along_axis(qs32, jnp.clip(j_init, 0, Qe - 1), axis=0)
    q0 = jnp.where((j_init >= 0) & (j_init < qlen), q0, 4)
    m1 = jnp.full((1, G), np.int32(-1))
    carry = (
        i0, Hband0, jnp.zeros((BW, G), jnp.int32), q0,
        jnp.zeros((1, G), jnp.int32),                  # beg
        qlen,                                          # end
        h0,                                            # best
        m1, m1, m1, m1,                    # best_i, best_j, best_ie, gscore
        jnp.zeros((1, G), jnp.int32),                  # max_off
        jnp.ones((1, G), jnp.int32),                   # active
    )
    out = jax.lax.while_loop(
        lambda st: (st[0] < Te) & jnp.any(st[12] != 0), body, carry)
    (_, _, _, _, _, _, best, best_i, best_j, best_ie, gscore, moff,
     _) = out
    return ExtendResult(best[0], best_j[0] + 1, best_i[0] + 1,
                        best_ie[0] + 1, gscore[0], moff[0])

"""Pallas (Triton route) kernel for the batched Myers bit-parallel gap DP.

Same semantics as ops/gap_dp.py `gap_align` (the jnp kernel, which stays
the oracle and the CPU path): NW / SHW edit distance with full path under
the oracle's traceback priority (consume-query, then consume-target, then
diagonal), including the edlib negative-end SHW artifact.  Reference
semantics: lib/edlib/edlib.cpp:334-470 (calculateBlock), :475-870 (NW/SHW
drivers).

Why a kernel: XLA turns `gap_align` into a while loop over the T target
columns with an inner scan over the W = Q/32 query words — tens of
thousands of dependent tiny steps per bucket — and round-trips the
(T, G, W) decision bitplanes through device memory, with one gather per
traceback step.  Here the fill and the traceback of a block of gaps run
inside one kernel:

- Gaps ride the lanes of a block (GB lanes, one thread per gap); every
  program owns GB consecutive gaps.  The work is integer and
  bit-parallel, so registers, not tensor cores, are the resource.
- The T-column fill is an in-kernel loop.  For W <= UNROLL_W the W query
  words are unrolled and Pv/Mv are loop-carried registers; wider queries
  keep Pv/Mv in a (W, G) device-memory scratch (L1/L2-resident per block)
  and loop over words.
- With `with_path`, the two decision bitplanes (PvOut = "up" bits,
  pre-shift Ph = "left" bits) go to device memory as extra outputs and
  the traceback runs in the same kernel in **column lockstep**: a shared
  column cursor walks T-1..0; a gap activates when the cursor reaches its
  end column.  Per column, the run of consume-query moves is the run of
  set "up" bits below the gap's current row, found by a per-lane word scan
  with count-leading-zeros.  Each gap emits one (run, move) pair per
  column; the host expands these to the oracle's move array.  Without
  `with_path` (the engine's plain-gap pass, which needs only dist/end)
  no bitplane is written and no traceback runs.

The per-column code is `(run << 2) | move` with move in {OP_MATCH,
OP_DELETE, OP_MISMATCH}; in forward order, runs count the OP_INSERTs
following the move; `lead` counts the path-leading inserts.
Forward path = [INSERT]*lead + concat_{c=0..end}([move_c] + [INSERT]*run_c).

All literals are typed int32/uint32: `jax_enable_x64` is on package-wide
and a bare Python int would otherwise trace as int64 inside the kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .gap_dp import OP_MATCH, OP_INSERT, OP_DELETE, OP_MISMATCH, _build_peq

INT32_MAX = np.int32(2**31 - 1)
GB = 32          # gaps (lanes) per program: one warp, one thread per gap
UNROLL_W = 16    # widest query (in 32-bit words) kept in registers

_I0, _I1 = np.int32(0), np.int32(1)
_U0, _U1 = np.uint32(0), np.uint32(1)
_UF = np.uint32(0xFFFFFFFF)


class GapColsResult(NamedTuple):
    dist: jnp.ndarray      # (G,) int32
    end: jnp.ndarray       # (G,) int32 (SHW best end / -1; NW: tl-1)
    lead: Optional[jnp.ndarray]     # (G,) int32 path-leading insert count
    # (T, G) uint16: (run << 2) | move per column; the host decode reads
    # columns via a free .T view
    colcode: Optional[jnp.ndarray]


def supports(Q: int, T: int) -> bool:
    """Buckets the kernel serves on the GPU (every configured bucket; the
    per-bucket timings that decided this are in PERF.md)."""
    return Q % 32 == 0


def kernel_for(backend: str, Q: int, T: int) -> str:
    """Gap-DP implementation for bucket (Q, T) on `backend`: "pallas"
    (this kernel) on the GPU where supports(Q, T), else "jnp"
    (gap_dp.gap_align); the CPU always runs "jnp".  Any other backend
    raises."""
    if backend == "gpu":
        return "pallas" if supports(Q, T) else "jnp"
    if backend == "cpu":
        return "jnp"
    raise ValueError(f"no gap-DP kernel for backend {backend!r}")


def _word_step(pv, mv, eq, hin):
    """One 32-row Myers block update (edlib calculateBlock) with the
    horizontal delta hin in {-1, 0, +1} entering at the top.  Returns
    (PvOut, MvOut, Ph_pre, Mh_pre, hout)."""
    hin_neg = jnp.where(hin < 0, _U1, _U0)
    hin_pos = jnp.where(hin > 0, _U1, _U0)
    xv = eq | mv
    eq2 = eq | hin_neg
    xh = (((eq2 & pv) + pv) ^ pv) | eq2
    ph = mv | ~(xh | pv)
    mh = pv & xh
    hout = ((ph >> np.uint32(31)).astype(jnp.int32)
            - (mh >> np.uint32(31)).astype(jnp.int32))
    ph_s = (ph << _U1) | hin_pos
    mh_s = (mh << _U1) | hin_neg
    return mh_s | ~(xv | ph_s), ph_s & xv, ph, mh, hout


def _make_kernel(T: int, W: int, with_path: bool):
    unroll = W <= UNROLL_W

    def kernel(peq_ref, ts_ref, ql_ref, tl_ref, shw_ref, *outs):
        if with_path:
            dist_ref, end_ref, lead_ref, cc_ref, up_ref, left_ref = outs[:6]
            outs = outs[6:]
        else:
            dist_ref, end_ref = outs[:2]
            outs = outs[2:]
        if not unroll:
            pv_ref, mv_ref = outs
        base = pl.program_id(0) * np.int32(GB)
        lanes = pl.ds(base, GB)
        lane_idx = base + jax.lax.broadcasted_iota(jnp.int32, (GB,), 0)
        ql = ql_ref[lanes]
        tl = tl_ref[lanes]
        shw = shw_ref[lanes]
        bw = (ql - _I1) >> np.int32(5)               # word of row ql-1
        bb = ((ql - _I1) & np.int32(31)).astype(jnp.uint32)
        w64 = (np.int32(64) - ql % np.int32(64)) % np.int32(64)
        neg1_cap = jnp.minimum(w64, tl)
        ones = jnp.ones((GB,), jnp.int32)
        zeros = jnp.zeros((GB,), jnp.int32)

        def eq_word(tchar, w):
            eq = peq_ref[w, lanes]
            for k in range(1, 5):
                eq = jnp.where(tchar == k, peq_ref[k * W + w, lanes], eq)
            return eq

        def word(c, w, tchar, pv, mv, hin, pb, mb):
            pv_o, mv_o, ph, mh, hout = _word_step(pv, mv, eq_word(tchar, w),
                                                  hin)
            if with_path:
                up_ref[c * W + w, lanes] = pv_o
                left_ref[c * W + w, lanes] = ph
            at = bw == w
            pb = jnp.where(at, ((ph >> bb) & _U1).astype(jnp.int32), pb)
            mb = jnp.where(at, ((mh >> bb) & _U1).astype(jnp.int32), mb)
            return pv_o, mv_o, hout, pb, mb

        def column_stats(c, pb, mb, score, dist, best, best_end, neg1):
            score = score + pb - mb
            dist = jnp.where(c == tl - _I1, score, dist)
            in_range = c < tl
            upd = in_range & (score < best)
            best_end = jnp.where(upd, c, best_end)
            best = jnp.where(upd, score, best)
            j = c + _I1
            neg1 = jnp.where(in_range & (j <= neg1_cap),
                             jnp.minimum(neg1, score + j), neg1)
            return score, dist, best, best_end, neg1

        stats0 = (ql,                                  # score = D(ql-1,-1)
                  jnp.full((GB,), INT32_MAX), jnp.full((GB,), INT32_MAX),
                  jnp.full((GB,), np.int32(-2)),
                  jnp.where(w64 >= _I1, ql, INT32_MAX))  # j = 0 term
        if unroll:
            def fill(c, carry):
                Pv, Mv, stats = carry
                tchar = ts_ref[c, lanes]
                hin, pb, mb = ones, zeros, zeros
                Pv2, Mv2 = [], []
                for w in range(W):
                    pv_o, mv_o, hin, pb, mb = word(
                        c, np.int32(w), tchar, Pv[w], Mv[w], hin, pb, mb)
                    Pv2.append(pv_o)
                    Mv2.append(mv_o)
                return (tuple(Pv2), tuple(Mv2),
                        column_stats(c, pb, mb, *stats))

            init = (tuple(jnp.full((GB,), _UF) for _ in range(W)),
                    tuple(jnp.zeros((GB,), jnp.uint32) for _ in range(W)),
                    stats0)
            _, _, stats = jax.lax.fori_loop(_I0, np.int32(T), fill, init)
        else:
            def init_word(w, _):
                pv_ref[w, lanes] = jnp.full((GB,), _UF)
                mv_ref[w, lanes] = jnp.zeros((GB,), jnp.uint32)
                return _

            jax.lax.fori_loop(_I0, np.int32(W), init_word, _I0)

            def fill(c, stats):
                tchar = ts_ref[c, lanes]

                def wbody(w, st):
                    hin, pb, mb = st
                    pv_o, mv_o, hin, pb, mb = word(
                        c, w, tchar, pv_ref[w, lanes], mv_ref[w, lanes],
                        hin, pb, mb)
                    pv_ref[w, lanes] = pv_o
                    mv_ref[w, lanes] = mv_o
                    return hin, pb, mb

                _, pb, mb = jax.lax.fori_loop(_I0, np.int32(W), wbody,
                                              (ones, zeros, zeros))
                return column_stats(c, pb, mb, *stats)

            stats = jax.lax.fori_loop(_I0, np.int32(T), fill, stats0)
        _, nw_dist, best, best_end, neg1 = stats

        use_neg1 = (w64 >= _I1) & (neg1 <= best)
        shw_dist = jnp.where(use_neg1, neg1,
                             jnp.where(best_end == -2, ql, best))
        shw_end = jnp.where(use_neg1 | (best_end == -2), np.int32(-1),
                            best_end)
        is_shw = shw != 0
        end = jnp.where(is_shw, shw_end, tl - _I1)
        dist_ref[lanes] = jnp.where(is_shw, shw_dist, nw_dist)
        end_ref[lanes] = end
        if not with_path:
            return

        # ---- traceback: shared column cursor T-1..0; active gaps stay in
        # lockstep (one column transition per iteration) ----
        def tb(k, r):
            c = np.int32(T - 1) - k
            active = c <= end
            # p = highest row <= r whose "up" bit is clear (-1 if none):
            # scan words downward from r's word until one has a clear bit
            rc = jnp.maximum(r, _I0)
            rb = (rc & np.int32(31)).astype(jnp.uint32)
            mask0 = jnp.where(rb == np.uint32(31), _UF,
                              (_U1 << (rb + _U1)) - _U1)

            def scan_cond(st):
                return jnp.max(st[3].astype(jnp.int32)) > _I0

            def scan_body(st):
                wi, mask, p, pending = st
                v = up_ref[c * W + jnp.maximum(wi, _I0), lane_idx]
                z = ~v & mask
                hit = z != _U0
                hb = np.int32(31) - jax.lax.clz(
                    jax.lax.bitcast_convert_type(z, jnp.int32))
                p = jnp.where(pending & hit, np.int32(32) * wi + hb, p)
                wi = wi - _I1
                pending = pending & ~hit & (wi >= _I0)
                return wi, jnp.full((GB,), _UF), p, pending

            _, _, p, _ = jax.lax.while_loop(
                scan_cond, scan_body,
                (rc >> np.int32(5), mask0, jnp.full((GB,), np.int32(-1)),
                 active & (r >= _I0)))
            run = r - p
            # the column-transition move at row p
            pc = jnp.maximum(p, _I0)
            rw = pc >> np.int32(5)
            pb_ = (pc & np.int32(31)).astype(jnp.uint32)
            tchar = ts_ref[c, lanes]
            left = left_ref[c * W + rw, lane_idx]
            eqw = peq_ref[tchar * np.int32(W) + rw, lane_idx]
            is_del = (p < _I0) | (((left >> pb_) & _U1) != _U0)
            is_eq = ((eqw >> pb_) & _U1) != _U0
            mv = jnp.where(is_del, np.int32(OP_DELETE),
                           jnp.where(is_eq, np.int32(OP_MATCH),
                                     np.int32(OP_MISMATCH)))
            cc_ref[c, lanes] = jnp.where(active, mv | (run << np.int32(2)),
                                         _I0)
            return jnp.where(active, jnp.where(is_del, p, p - _I1), r)

        r_fin = jax.lax.fori_loop(_I0, np.int32(T), tb, ql - _I1)
        lead_ref[lanes] = r_fin + _I1

    return kernel


@functools.partial(jax.jit, static_argnums=(5, 6),
                   static_argnames=("with_path", "interpret"))
def gap_align_pl(qs, ql, ts, tl, is_shw, Q: int, T: int,
                 with_path: bool = True,
                 interpret: bool = False) -> GapColsResult:
    """Kernel-backed batched NW/SHW alignment; same inputs as
    gap_dp.gap_align, output as per-column run/move codes
    (GapColsResult; lead/colcode are None without `with_path`).  G is
    padded to a multiple of GB with (1, 1) dummy gaps.  `interpret` runs
    the kernel in the Pallas interpreter (CPU tests)."""
    assert Q % 32 == 0
    G = qs.shape[0]
    W = Q // 32
    Gp = -(-G // GB) * GB
    pad = Gp - G
    qs = jnp.pad(jnp.asarray(qs), ((0, pad), (0, 0)))
    ts = jnp.pad(jnp.asarray(ts), ((0, pad), (0, 0)))
    ql = jnp.pad(jnp.asarray(ql).astype(jnp.int32), (0, pad),
                 constant_values=1)
    tl = jnp.pad(jnp.asarray(tl).astype(jnp.int32), (0, pad),
                 constant_values=1)
    shw = jnp.pad(jnp.asarray(is_shw).astype(jnp.int32), (0, pad))
    peq = _build_peq(qs, Q, W)                       # (Gp, 5, W)
    peq = peq.transpose(1, 2, 0).reshape(5 * W, Gp)  # row = char*W + word
    ts_t = ts.astype(jnp.int32).T                    # (T, Gp)

    i32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.int32)
    u32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.uint32)
    out_shape = [i32(Gp), i32(Gp)]                   # dist, end
    if with_path:
        out_shape += [i32(Gp), i32(T, Gp),           # lead, colcode
                      u32(T * W, Gp), u32(T * W, Gp)]  # up / left planes
    if W > UNROLL_W:
        out_shape += [u32(W, Gp), u32(W, Gp)]        # Pv / Mv state
    out = pl.pallas_call(
        _make_kernel(T, W, with_path),
        out_shape=out_shape,
        grid=(Gp // GB,),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name=f"myers_gap_q{Q}_t{T}",
    )(peq, ts_t, ql, tl, shw)
    if not with_path:
        return GapColsResult(dist=out[0][:G], end=out[1][:G], lead=None,
                             colcode=None)
    return GapColsResult(dist=out[0][:G], end=out[1][:G], lead=out[2][:G],
                         colcode=out[3][:, :G].astype(jnp.uint16))


def _decode_native(colcode_tg, end, lead):
    """Native decode path; None when the C++ library is unavailable."""
    import ctypes

    from ..native import _load

    lib = _load()
    if lib is None or not hasattr(lib, "decode_colcodes"):
        return None
    g = len(end)
    T = colcode_tg.shape[0]
    col = np.ascontiguousarray(colcode_tg.T[:g], dtype=np.uint16)
    ends = np.ascontiguousarray(end, dtype=np.int64)
    leads = np.ascontiguousarray(lead, dtype=np.int64)
    # exact size: lead inserts + one move per emitted column + the insert
    # runs encoded in the codes themselves (columns past `end` are zeroed
    # by the kernel, so a full-row sum is the true run total)
    total_runs = int((col.astype(np.int64) >> 2).sum())
    cap = int(leads.sum() + (ends + 1).clip(0).sum() + total_runs)
    cap = max(cap, 64)
    out = np.empty(cap, np.uint8)
    offs = np.empty(g, np.int64)
    lens = np.empty(g, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    total = lib.decode_colcodes(
        col.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        T, ends.ctypes.data_as(i64p), leads.ctypes.data_as(i64p), g,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
        offs.ctypes.data_as(i64p), lens.ctypes.data_as(i64p),
    )
    if total < 0:
        return None
    return [out[offs[i] : offs[i] + lens[i]] for i in range(g)]


def decode_col_moves(colcode_tg: np.ndarray, end: np.ndarray,
                     lead: np.ndarray) -> list:
    """Host-side: expand per-column (run, move) codes into the oracle's
    forward move arrays.  colcode_tg is the kernel's (T, G) layout (see
    GapColsResult.colcode).  Uses the native decoder when available;
    both produce identical arrays."""
    native = _decode_native(colcode_tg, end, lead)
    if native is not None:
        return native
    colcode = colcode_tg.T
    G = colcode.shape[0]
    out = []
    for g in range(G):
        e = int(end[g])
        ld = int(lead[g])
        if e < 0:
            out.append(np.full(ld, OP_INSERT, np.uint8))
            continue
        codes = colcode[g, : e + 1].astype(np.int64)
        n = e + 1
        vals = np.empty(2 * n + 1, np.uint8)
        cnts = np.empty(2 * n + 1, np.int64)
        vals[0] = OP_INSERT
        cnts[0] = ld
        vals[1::2] = (codes & 3).astype(np.uint8)
        cnts[1::2] = 1
        vals[2::2] = OP_INSERT
        cnts[2::2] = codes >> 2
        out.append(np.repeat(vals, cnts))
    return out

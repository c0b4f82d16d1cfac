"""Batched affine extension (ops/affine_pl.py, plain jnp/lax) vs the host
scalar oracle (native/align_eq.cpp sw_extend via align.edlib_eq.ksw_extend2):
score / qle / tle / gtle / gscore / max_off exact across random related
and unrelated sequence pairs, both parameter sets the engine uses (clip:
band 40, o=0/e=1; split: bands 100, o_del 8 / o_ins 4), z-drop and the
band clamp included."""

import numpy as np
import pytest

from lordfast_tpu.align import edlib_eq as ed
from lordfast_tpu.ops import affine_pl


def _mutate(q, rng, err=0.15):
    out = []
    for ch in q:
        r = rng.random()
        if r < err / 3:
            out.append(rng.integers(0, 4))
        elif r < 2 * err / 3:
            out.append(ch)
            out.append(rng.integers(0, 4))
        elif r < err:
            continue
        else:
            out.append(ch)
    return np.array(out or [0], np.uint8)


PARAM_SETS = [
    # (o_del, e_del, o_ins, e_ins, w, zdrop)  — clip (LordFAST.cpp:1848)
    (0, 1, 0, 1, 40, 40),
    # split (LordFAST.cpp:1971)
    (8, 1, 4, 1, 100, 200),
]
MAT = ed.build_ksw_matrix(2, 16)


def _run_group(pairs, params, h0s, Qe, Te):
    G = len(pairs)
    BW, w_max = 256, 100
    qs = np.zeros((G, Qe), np.uint8)
    ts = np.zeros((G, Te), np.uint8)
    qlen = np.zeros(G, np.int32)
    tlen = np.zeros(G, np.int32)
    cols = {k: np.zeros(G, np.int32) for k in
            ("o_del", "e_del", "o_ins", "e_ins", "w_eff", "zdrop", "h0")}
    for g, (q, t) in enumerate(pairs):
        qs[g, : len(q)] = q
        ts[g, : len(t)] = t
        qlen[g], tlen[g] = len(q), len(t)
        od, ed_, oi, ei, w, zd = params[g]
        cols["o_del"][g], cols["e_del"][g] = od, ed_
        cols["o_ins"][g], cols["e_ins"][g] = oi, ei
        cols["zdrop"][g] = zd
        cols["h0"][g] = h0s[g]
        cols["w_eff"][g] = affine_pl.clamp_band(
            len(q), 2, 0, od, ed_, oi, ei, w
        )
    res = affine_pl.extend_batch(
        qs, ts, Qe, Te, BW, w_max,
        qlen=qlen, tlen=tlen, match=np.full(G, 2, np.int32),
        mismatch=np.full(G, 16, np.int32), **cols,
    )
    for g, (q, t) in enumerate(pairs):
        od, ed_, oi, ei, w, zd = params[g]
        want = ed.ksw_extend2(
            q, t, MAT, od, ed_, oi, ei, w, 0, zd, int(h0s[g]),
            with_max_off=True,
        )
        got = (int(res.score[g]), int(res.qle[g]), int(res.tle[g]),
               int(res.gtle[g]), int(res.gscore[g]), int(res.max_off[g]))
        assert got == want, (
            f"g={g} ql={len(q)} tl={len(t)} params={params[g]} "
            f"h0={h0s[g]}: {got} != {want}"
        )


def test_affine_related_pairs(rng):
    G = 24
    pairs, params, h0s = [], [], []
    for g in range(G):
        n = int(rng.integers(30, 400))
        q = rng.integers(0, 4, n).astype(np.uint8)
        t = _mutate(q, rng, err=float(rng.uniform(0.05, 0.3)))[:480]
        pairs.append((q, t))
        params.append(PARAM_SETS[g % 2])
        h0s.append(int(rng.integers(1, 2 * n + 1)))
    _run_group(pairs, params, h0s, 512, 512)


def test_affine_junk_and_zdrop(rng):
    # unrelated sequences: z-drop terminates early; exact break timing
    G = 16
    pairs, params, h0s = [], [], []
    for g in range(G):
        nq = int(rng.integers(50, 500))
        nt = int(rng.integers(50, 500))
        pairs.append((rng.integers(0, 4, nq).astype(np.uint8),
                      rng.integers(0, 4, nt).astype(np.uint8)))
        params.append(PARAM_SETS[g % 2])
        h0s.append(nq)  # engine convention: h0 = r_len
    _run_group(pairs, params, h0s, 512, 512)


def test_affine_small_and_edge(rng):
    # tiny queries exercise the max_ins/max_del band clamp; N codes
    pairs, params, h0s = [], [], []
    sizes = [1, 2, 3, 5, 8, 13, 21, 34]
    for i, n in enumerate(sizes):
        q = rng.integers(0, 5, n).astype(np.uint8)   # incl. N
        t = rng.integers(0, 5, int(rng.integers(1, 3 * n + 2))).astype(
            np.uint8
        )
        pairs.append((q, t))
        params.append(PARAM_SETS[i % 2])
        h0s.append(max(1, n // 2))
    _run_group(pairs, params, h0s, 64, 128)

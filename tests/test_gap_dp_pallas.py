"""Myers gap kernel (ops/gap_dp_pallas.py) vs the jnp reference kernel
and the host oracle: distances, SHW ends (incl. the negative-end
artifact) and byte-identical move paths.  Runs the kernel in the Pallas
interpreter on the CPU backend (tests/conftest.py forces CPU); the same
kernel compiled for the GPU is checked by chip_smoke.py's kernel phase
(tests/test_gpu.py runs it where a card exists)."""

import numpy as np
import pytest

from lordfast_tpu.align import edlib_eq as ed
from lordfast_tpu.config import LordfastConfig
from lordfast_tpu.ops import gap_dp
from lordfast_tpu.ops import gap_dp_pallas as gp

from test_gap_dp import _random_pair


def _run(pairs, modes, Q, T):
    G = len(pairs)
    qs = np.zeros((G, Q), np.uint8)
    ts = np.zeros((G, T), np.uint8)
    ql = np.zeros(G, np.int32)
    tl = np.zeros(G, np.int32)
    for g, (q, t) in enumerate(pairs):
        qs[g, : len(q)] = q
        ts[g, : len(t)] = t
        ql[g] = len(q)
        tl[g] = len(t)
    res = gp.gap_align_pl(qs, ql, ts, tl, np.asarray(modes, bool), Q, T,
                          interpret=True)
    dist = np.asarray(res.dist)
    end = np.asarray(res.end)
    moves = gp.decode_col_moves(np.asarray(res.colcode), end,
                                np.asarray(res.lead))
    return dist, end, moves


def test_pallas_nw_and_shw_vs_oracle(rng):
    pairs = [_random_pair(rng, 120, 150) for _ in range(32)]
    modes = [bool(rng.integers(0, 2)) for _ in range(32)]
    dist, end, moves = _run(pairs, modes, 128, 160)
    for g, (q, t) in enumerate(pairs):
        if modes[g]:
            d_ref, e_ref, mv_ref = ed.shw_path(q, t)
            assert end[g] == e_ref, f"gap {g}: end {end[g]} != {e_ref}"
        else:
            d_ref, mv_ref = ed.nw_path(q, t)
            assert end[g] == len(t) - 1
        assert dist[g] == d_ref, f"gap {g}: dist {dist[g]} != {d_ref}"
        np.testing.assert_array_equal(
            moves[g], mv_ref, err_msg=f"gap {g} path mismatch"
        )


def test_pallas_word_boundaries_vs_jnp(rng):
    # ql at 32-bit word boundaries: carry chains + the W64 artifact, and
    # multi-word states (W=4) — compared against the jnp kernel, which is
    # itself oracle-tested in test_gap_dp.py
    sizes = [1, 31, 32, 33, 63, 64, 65, 96, 127, 128]
    pairs = []
    for s in sizes:
        q = rng.integers(0, 4, s).astype(np.uint8)
        t = rng.integers(0, 4, max(1, s + int(rng.integers(-8, 10)))).astype(
            np.uint8
        )
        pairs.append((q, t))
    G, Q, T = len(pairs), 128, 160
    for mode in (False, True):
        dist, end, moves = _run(pairs, [mode] * G, Q, T)
        qs = np.zeros((G, Q), np.uint8)
        ts = np.zeros((G, T), np.uint8)
        ql = np.zeros(G, np.int32)
        tl = np.zeros(G, np.int32)
        for g, (q, t) in enumerate(pairs):
            qs[g, : len(q)] = q
            ts[g, : len(t)] = t
            ql[g], tl[g] = len(q), len(t)
        ref = gap_dp.gap_align(qs, ql, ts, tl,
                               np.asarray([mode] * G, bool), Q, T)
        ref_moves = gap_dp.unpack_moves(np.asarray(ref.moves_packed),
                                        np.asarray(ref.mlen))
        np.testing.assert_array_equal(dist, np.asarray(ref.dist))
        np.testing.assert_array_equal(end, np.asarray(ref.end))
        for g in range(G):
            np.testing.assert_array_equal(
                moves[g], ref_moves[g], err_msg=f"ql={sizes[g]} mode={mode}"
            )


def _vs_jnp(pairs, modes, Q, T, with_path=True):
    """Kernel (interpret mode) against gap_dp.gap_align on the same batch:
    dist, end and (with_path) the decoded move paths, exactly."""
    G = len(pairs)
    qs = np.zeros((G, Q), np.uint8)
    ts = np.zeros((G, T), np.uint8)
    ql = np.zeros(G, np.int32)
    tl = np.zeros(G, np.int32)
    for g, (q, t) in enumerate(pairs):
        qs[g, : len(q)] = q
        ts[g, : len(t)] = t
        ql[g], tl[g] = len(q), len(t)
    shw = np.asarray(modes, bool)
    ref = gap_dp.gap_align(qs, ql, ts, tl, shw, Q, T)
    res = gp.gap_align_pl(qs, ql, ts, tl, shw, Q, T, with_path=with_path,
                          interpret=True)
    np.testing.assert_array_equal(np.asarray(res.dist), np.asarray(ref.dist))
    np.testing.assert_array_equal(np.asarray(res.end), np.asarray(ref.end))
    if not with_path:
        assert res.lead is None and res.colcode is None
        return
    moves = gp.decode_col_moves(np.asarray(res.colcode),
                                np.asarray(res.end), np.asarray(res.lead))
    ref_moves = gap_dp.unpack_moves(np.asarray(ref.moves_packed),
                                    np.asarray(ref.mlen))
    for g in range(G):
        np.testing.assert_array_equal(moves[g], ref_moves[g],
                                      err_msg=f"gap {g} path mismatch")


def _related(rng, Q, T, n_gaps):
    pairs = []
    for g in range(n_gaps):
        q = rng.integers(0, 4, int(rng.integers(Q - Q // 4, Q + 1))).astype(
            np.uint8)
        t = q.copy()
        sites = rng.integers(0, len(t), max(1, len(t) // 9))
        t[sites] = rng.integers(0, 4, len(sites))
        extra = rng.integers(0, 4, T - len(t)).astype(np.uint8)
        t = np.concatenate([t, extra])[: int(rng.integers(T - T // 4,
                                                          T + 1))]
        pairs.append((q, t))
    return pairs


@pytest.mark.parametrize("Q,T", [(2048, 2176), (4096, 4352)])
def test_pallas_wide_bucket_vs_jnp(rng, Q, T):
    # the two widest configured gap buckets: W = Q/32 > UNROLL_W, so the
    # kernel keeps Pv/Mv in its device-memory scratch and loops over words
    assert (Q, T) in [b[:2] for b in LordfastConfig().gap_buckets]
    assert Q // 32 > gp.UNROLL_W
    pairs = _related(rng, Q, T, 3)
    _vs_jnp(pairs, [False, True, True], Q, T)


@pytest.mark.parametrize("G", [5, 33])
def test_pallas_padding_and_no_path(rng, G):
    # G not a multiple of the 32-lane block: the wrapper pads with (1, 1)
    # dummies (33 -> two programs); the no-path variant returns the same
    # dist/end without lead/colcode
    pairs = _related(rng, 64, 96, G)
    modes = [g % 3 == 0 for g in range(G)]
    _vs_jnp(pairs, modes, 64, 96)
    _vs_jnp(pairs, modes, 64, 96, with_path=False)


@pytest.mark.parametrize("backend,want", [
    ("gpu", "pallas"), ("cpu", "jnp"), ("rocm", None), ("metal", None)])
def test_kernel_choice_per_backend(backend, want):
    for Q, T, _ in LordfastConfig().gap_buckets:
        if want is None:
            with pytest.raises(ValueError):
                gp.kernel_for(backend, Q, T)
        else:
            assert gp.kernel_for(backend, Q, T) == want


def test_pallas_negative_end_artifact():
    q = np.array([0], np.uint8)
    t = np.array([1, 1, 1], np.uint8)
    d_ref, e_ref, mv_ref = ed.shw_path(q, t)
    dist, end, moves = _run([(q, t)], [True], 32, 48)
    assert (dist[0], end[0]) == (d_ref, e_ref)
    np.testing.assert_array_equal(moves[0], mv_ref)

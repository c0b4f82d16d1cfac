"""End-to-end mapping engine.

Orchestrates the per-chunk flow of the reference driver
(src/baseFAST.cpp:44-82: readChunk -> initFASTChunk -> mapSeqMT ->
releaseChunk) with the device/host split of this build:

  device (batched over reads): seeding -> window voting -> per-window seed
  selection -> chaining DP;
  host: chain stitching (gap DP via native edlib-equivalents), scoring,
  mode resolution (coarse vs fine, src/LordFAST.cpp:542-569), SAM output
  in input order (the reference's output order is thread-nondeterministic;
  we define it as input order, SURVEY.md §4).
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional, TextIO

import numpy as np

from ..align.chain_align import Mapping, align_and_score
from ..config import LordfastConfig
from ..index.container import FMIndex
from ..io import sam as sam_io
from ..io.fastx import Read, read_chunks
from ..ops import chain as chain_ops
from ..ops import fm_index as fm_ops
from ..ops import gap_dp
from ..ops import gap_dp_pallas
from ..ops import voting as vote_ops
from ..utils.checkpoint import ChunkProgress
from ..utils.metrics import Metrics
from ..utils.pack import seq_to_codes, revcomp_codes


def _pad_to_bucket(n: int, buckets=(1024, 2048, 4096, 8192, 16384, 32768,
                                    65536, 131072, 262144)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class MappingEngine:
    def __init__(self, idx: FMIndex, cfg: Optional[LordfastConfig] = None,
                 mesh=None, shard_index: bool = False,
                 esc_device: bool = False):
        """mesh: optional jax.sharding.Mesh with a "data" axis — the device
        stage is then sharded over reads across the mesh with the index
        replicated (the device analog of the reference's pthread pool,
        src/LordFAST.cpp:305-316).  cfg.batch_reads must be divisible by
        the mesh size.

        shard_index: stripe the FM-index rank/SA arrays over the mesh
        instead of replicating them, with interval-routed lookups
        (parallel/sharded_index.py; SURVEY.md §5.8) — for indexes too big
        for one device's memory.  Requires mesh.

        esc_device: run the clip / split escalation DPs as one batched
        device pass (True) or inside the host stitcher (False, the
        default on every backend: faster end to end on the H100, see
        PERF.md)."""
        self.idx = idx
        self.cfg = (cfg or LordfastConfig()).validate()
        self.meta = idx.meta
        # the voting keys pack the window id into 30 bits (ops/voting.py);
        # win = t_pos // read_len stays below 2^30 whenever
        # 2*l_pac / min_read_len does (~54 Gbp at the default floor).
        # Anything larger would corrupt cross-window neighbor checks
        # silently — reject it up front (ADVICE r4)
        if (2 * idx.l_pac) // max(self.cfg.min_read_len, 1) >= 2**30:
            raise ValueError(
                "genome too large for the 30-bit voting window ids: "
                f"2*l_pac={2 * idx.l_pac} with min_read_len="
                f"{self.cfg.min_read_len} overflows 2^30 windows"
            )
        self.mesh = mesh
        self.stats = {"reads": 0, "mapped": 0, "chunks": 0, "batches": 0}
        self.metrics = Metrics(verbosity=getattr(self.cfg, "verbosity", 0))
        # host worker pool over stitch jobs — the analog of the
        # reference's per-core pthread pool (src/LordFAST.cpp:305-316).
        # The native stitcher runs with the GIL released (ctypes), so
        # threads scale across host cores; 0 = one per core.
        import os

        import jax

        # gap-DP kernel per bucket: the Myers kernel on the GPU, the jnp
        # kernel on the CPU (tests/golden); any other backend raises here
        self._backend = jax.default_backend()
        gap_dp_pallas.kernel_for(self._backend, *self.cfg.gap_buckets[0][:2])
        self._esc_device = esc_device
        self._gap_shapes_seen = set()

        n_workers = self.cfg.num_threads or (os.cpu_count() or 1)
        if n_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=n_workers)
        else:
            self._pool = None
        # one jitted function for the whole device stage: eager op-by-op
        # dispatch costs a host<->device roundtrip per op
        from ..parallel.mesh import device_pipeline
        import jax
        fn = device_pipeline(self.meta, self.cfg)
        if shard_index and mesh is None:
            raise ValueError("shard_index requires a mesh")
        self._shard_index = shard_index
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            assert self.cfg.batch_reads % mesh.size == 0, (
                "batch_reads must be divisible by the mesh size"
            )
            repl = NamedSharding(mesh, P())
            self._shard0 = NamedSharding(mesh, P("data"))
            if shard_index:
                from ..parallel.sharded_index import sharded_index_pipeline

                self._device_fn, self.arrs = sharded_index_pipeline(
                    idx, self.cfg, mesh
                )
            else:
                self.arrs = idx.device_arrays(sharding=repl)
                self._device_fn = jax.jit(
                    fn, in_shardings=(None, self._shard0, self._shard0,
                                      self._shard0),
                )
        else:
            self._shard0 = None
            self.arrs = idx.device_arrays()
            self._device_fn = jax.jit(fn)
        # lazily-built wide-budget pipelines for the compact-overflow
        # retries (fine-mode reads whose windows ran out of K slots; the
        # reference chains every qualifying local max,
        # src/LordFAST.cpp:874-904): 8x shared budget first, then a
        # solo-read pipeline with a 512-window budget
        self._big_fn = None
        self._solo_fn = None
        self._post_fns = {}  # dormant-seeder post-stage pipelines

    def _put_reads(self, arr: np.ndarray):
        import jax

        if self._shard0 is not None:
            return jax.device_put(arr, self._shard0)
        return jax.device_put(arr)

    # ---- device stage ----
    def _device_stage(self, reads_arr, lens: np.ndarray, big: bool = False,
                      host_seeds=None):
        import jax

        if host_seeds is not None:
            fn = self._get_post_fn("big" if big else "base",
                                   big_budget=big)
            return fn(self.arrs, host_seeds, reads_arr,
                      np.asarray(lens, np.int32))
        pos = fm_ops.sample_positions_host(lens, self.cfg.sampling_count)
        if self._shard0 is not None:
            lens = jax.device_put(np.asarray(lens), self._shard0)
            pos = jax.device_put(np.asarray(pos), self._shard0)
        fn = self._get_big_fn() if big else self._device_fn
        return fn(self.arrs, reads_arr, lens, pos)

    def _host_seeds(self, arr: np.ndarray, lens: np.ndarray):
        """Dormant-seeder path (cfg.seeder != "extend-whole"): seed on
        the host (ops/seeders.py), then run the jitted post-seeding
        pipeline."""
        from ..ops.seeders import host_seed_batch

        sb = host_seed_batch(self.idx, arr, lens, self.cfg,
                             self.cfg.max_seeds_per_read)
        pdt = self.idx.pos_dtype
        return sb._replace(t_pos=sb.t_pos.astype(pdt))

    def _get_post_fn(self, key: str, big_budget: bool = False):
        if key not in self._post_fns:
            import jax

            from ..parallel.mesh import post_seed_stage

            cfg = self.cfg
            if big_budget:
                cfg = cfg.replace(
                    max_candidates=min(4 * cfg.max_candidates, 256),
                    compact_windows_per_read=8
                    * cfg.compact_windows_per_read,
                )
            elif key == "solo":
                bs = self.mesh.size if self.mesh is not None else 1
                # ceil division: total K = bs * per_read must reach the
                # 512 candidate cap even when bs does not divide 512
                cfg = cfg.replace(max_candidates=512,
                                  compact_windows_per_read=-(-512 // bs))
            if key == "solo":  # paged (see _solo_retry)
                self._post_fns[key] = jax.jit(
                    lambda a, s, r, ln, page, _cfg=cfg: post_seed_stage(
                        a, s, r, ln, _cfg, page
                    )
                )
            else:
                self._post_fns[key] = jax.jit(
                    lambda a, s, r, ln, _cfg=cfg: post_seed_stage(
                        a, s, r, ln, _cfg
                    )
                )
        return self._post_fns[key]

    def _make_fn(self, cfg_var, paged: bool = False):
        """jit the device pipeline for cfg_var.  paged=True: the jitted
        function takes a 5th traced candidate-rank page argument (the
        window-paging escalation; one compile covers every page)."""
        import jax

        from ..parallel.mesh import device_pipeline

        if self._shard_index:
            from ..parallel.sharded_index import sharded_index_pipeline

            fn, _ = sharded_index_pipeline(
                self.idx, cfg_var, self.mesh, arrs=self.arrs, paged=paged
            )
            return fn
        fn = device_pipeline(self.meta, cfg_var)
        if paged:
            base = fn
            fn = lambda a, r, ln, p, page: base(a, r, ln, p, page)
        if self.mesh is not None:
            sh = (None, self._shard0, self._shard0, self._shard0)
            if paged:
                sh = sh + (None,)
            return jax.jit(fn, in_shardings=sh)
        return jax.jit(fn)

    def _get_big_fn(self):
        """Device pipeline with 8x the candidate/compact-window budget,
        compiled on first overflow (rare: repeat-dense reads only)."""
        if self._big_fn is None:
            self._big_fn = self._make_fn(self.cfg.replace(
                max_candidates=min(4 * self.cfg.max_candidates, 256),
                compact_windows_per_read=8
                * self.cfg.compact_windows_per_read,
            ))
        return self._big_fn

    def _solo_retry(self, codes, L, page: int = 0):
        """Last-resort retry for a read whose candidate windows overflow
        even the 8x shared budget: run it ALONE through a pipeline whose
        per-read candidate cap and window slots both reach 512, so every
        qualifying window gets a chaining slot (the reference chains all
        of them, src/LordFAST.cpp:874-904).  page > 0 selects candidate
        ranks [512*page, 512*(page+1)) — the caller pages until a page
        is not saturated, so reads with thousands of qualifying windows
        still chain every one (the page index is a traced scalar: one
        compile covers all pages).  Returns (out, chains_dev) with the
        read at batch row 0."""
        import jax
        import numpy as np

        self._solo_bs = self.mesh.size if self.mesh is not None else 1
        if self._solo_fn is None and self.cfg.seeder == "extend-whole":
            # ceil division (see _get_post_fn "solo"): K >= max_candidates
            self._solo_fn = self._make_fn(self.cfg.replace(
                max_candidates=512,
                compact_windows_per_read=-(-512 // self._solo_bs),
            ), paged=True)
        bs = self._solo_bs
        arr = np.full((bs, L), 4, dtype=np.uint8)
        arr[0, : len(codes)] = codes
        lens = np.zeros(bs, np.int32)
        lens[0] = len(codes)
        rd = self._put_reads(arr)
        pg = np.int32(page)
        if self.cfg.seeder != "extend-whole":
            sb = self._host_seeds(arr, lens)
            fn = self._get_post_fn("solo")
            _, chains, host_out = fn(self.arrs, sb, rd, lens, pg)
            return jax.device_get(host_out), chains
        pos = fm_ops.sample_positions_host(lens, self.cfg.sampling_count)
        if self._shard0 is not None:
            lens_d = jax.device_put(np.asarray(lens), self._shard0)
            pos = jax.device_put(np.asarray(pos), self._shard0)
        else:
            lens_d = lens
        _, chains, host_out = self._solo_fn(self.arrs, rd, lens_d, pos,
                                            pg)
        return jax.device_get(host_out), chains

    # ---- per-read host resolution ----
    def _chain_rows(self, out, chains_dev, k: int, n: int, wide=None):
        """Chain arrays for window row k: from the eagerly-transferred
        trimmed tensors when the chain fits, else from the batched wide
        fetch (_fetch_wide_rows); a direct per-row device fetch only as
        a last resort."""
        if n <= out["chain_ql"].shape[1]:
            ql = out["chain_ql"][k, :n]
            return (ql >> 12).astype(np.int64), out["chain_t"][k, :n], \
                (ql & 4095).astype(np.int64)
        if wide is not None and k in wide:
            q, t, ln = wide[k]
            return (q[:n].astype(np.int64), t[:n],
                    ln[:n].astype(np.int64))
        import jax

        q, t, ln = jax.device_get(
            (chains_dev.q_pos[k, :n], chains_dev.t_pos[k, :n],
             chains_dev.length[k, :n])
        )
        return q, t, ln

    def _fetch_wide_rows(self, chains_dev, rows, nmax: int):
        """One batched device gather + device_get for every selected chain
        longer than the eager transfer cap — a single roundtrip per batch
        instead of one per row (roundtrip latency dominates on remote
        backends).  Row count and width are padded to buckets so XLA
        compiles a bounded set of gather shapes."""
        import jax
        import jax.numpy as jnp

        Nfull = chains_dev.q_pos.shape[1]
        W = Nfull
        for b in (192, 256, 384, 512, 1024, 2048, 4096):
            if nmax <= b <= Nfull:
                W = b
                break
        R = 8
        while R < len(rows):
            R <<= 1
        ridx = np.zeros(R, np.int32)
        ridx[: len(rows)] = rows
        ridx_dev = jnp.asarray(ridx)
        q, t, ln = jax.device_get((
            chains_dev.q_pos[ridx_dev, :W],
            chains_dev.t_pos[ridx_dev, :W],
            chains_dev.length[ridx_dev, :W],
        ))
        return {int(k): (q[i], t[i], ln[i]) for i, k in enumerate(rows)}

    def _select_rows(self, b: int, out, rows_by_read):
        """Window selection per read: coarse mode stitches the single
        top-vote window; fine mode the top max_map by chain score
        (src/LordFAST.cpp:542-569, 819-904).

        Returns (is_fine, selected_rows, overflowed): overflowed = the
        read's qualifying windows were not all chained — it got fewer
        compact-window slots than cand_need (shared K budget exhausted)
        or its per-read candidate cap C itself may be truncating
        (cand_sat: the lowest-vote candidate still qualifies).  The
        caller escalates through the 8x-budget then the solo pipeline
        rather than silently diverging from the reference (which chains
        every qualifying window, src/LordFAST.cpp:874-904)."""
        cfg = self.cfg
        if not out["cand_valid0"][b]:
            return False, [], False
        rows = rows_by_read.get(b, [])
        is_fine = bool(out["is_fine"][b])
        if not is_fine:
            selected = [k for k in rows if out["cw_cand_idx"][k] == 0][:1]
            return False, selected, not selected
        over = (len(rows) < int(out["cand_need"][b])
                or bool(out["cand_sat"][b]))
        selected = self._fine_heap_select(rows, out, cfg.max_map)
        return True, selected, over

    @staticmethod
    def _fine_heap_select(rows, out, max_map):
        """Replicate findTopWins_fine's top-window heap byte-for-byte
        (src/LordFAST.cpp:874-904): windows scanned forward strand first
        then reverse, ascending winId; a min-heap (std::push_heap /
        pop_heap with compareWin = score>) of float32 chain scores keeps
        the top maxWin, replacement only on STRICTLY greater score — so
        exact score ties at the cutoff keep the earliest-scanned window,
        and the emitted order is the heap's ARRAY order (alignWin walks
        list[0..num-1]; the final std::sort by totalScore is insertion
        sort — stable — for n <= 16).  The heap ops match libstdc++'s
        __push_heap / __adjust_heap element moves exactly."""
        import numpy as np

        def push_heap(h):  # __push_heap(first, len-1, 0, value)
            hole = len(h) - 1
            value = h[hole]
            parent = (hole - 1) >> 1
            while hole > 0 and h[parent][0] > value[0]:  # compareWin
                h[hole] = h[parent]
                hole = parent
                parent = (hole - 1) >> 1
            h[hole] = value

        def pop_heap(h):  # __pop_heap(first, last-1, last-1, value)
            n = len(h) - 1
            value = h[n]
            h[n] = h[0]
            # __adjust_heap(first, 0, n, value)
            hole, top, second = 0, 0, 0
            while second < (n - 1) >> 1:
                second = 2 * (second + 1)
                if h[second][0] > h[second - 1][0]:  # comp(right, left)
                    second -= 1
                h[hole] = h[second]
                hole = second
            if (n & 1) == 0 and second == (n - 2) >> 1:
                second = 2 * (second + 1)
                h[hole] = h[second - 1]
                hole = second - 1
            # __push_heap(first, hole, top, value)
            parent = (hole - 1) >> 1
            while hole > top and h[parent][0] > value[0]:
                h[hole] = h[parent]
                hole = parent
                parent = (hole - 1) >> 1
            h[hole] = value

        scan = sorted(
            rows,
            key=lambda k: (int(out["cw_is_rev"][k]),
                           int(out["cw_win_id"][k])),
        )
        heap = []
        for k in scan:
            s = np.float32(out["chain_score"][k])
            if len(heap) < max_map:
                heap.append((s, k))
                push_heap(heap)
            elif s > heap[0][0]:
                pop_heap(heap)
                heap[-1] = (s, k)
                push_heap(heap)
        return [k for _, k in heap]

    @classmethod
    def _fine_heap_select_multi(cls, pairs, ctxs, max_map):
        """_fine_heap_select over windows spread across several device
        contexts (the window-paging escalation): pairs = [(ctx_id, row)].
        Windows are deduped by (strand, winId) — page boundaries can
        overlap at the wide path's sort clamp — and scanned in the same
        fwd-then-rev ascending-winId order; returns selected pairs."""
        seen = set()
        items = []
        for ci, k in pairs:
            out = ctxs[ci][0]
            key = (int(out["cw_is_rev"][k]), int(out["cw_win_id"][k]))
            if key in seen:
                continue
            seen.add(key)
            items.append((key, np.float32(out["chain_score"][k]),
                          (ci, k)))
        items.sort(key=lambda x: x[0])
        # identical heap mechanics to _fine_heap_select
        heap = []

        def push(h):
            hole = len(h) - 1
            value = h[hole]
            parent = (hole - 1) >> 1
            while hole > 0 and h[parent][0] > value[0]:
                h[hole] = h[parent]
                hole = parent
                parent = (hole - 1) >> 1
            h[hole] = value

        def pop(h):
            n = len(h) - 1
            value = h[n]
            h[n] = h[0]
            hole, top, second = 0, 0, 0
            while second < (n - 1) >> 1:
                second = 2 * (second + 1)
                if h[second][0] > h[second - 1][0]:
                    second -= 1
                h[hole] = h[second]
                hole = second
            if (n & 1) == 0 and second == (n - 2) >> 1:
                second = 2 * (second + 1)
                h[hole] = h[second - 1]
                hole = second - 1
            parent = (hole - 1) >> 1
            while hole > top and h[parent][0] > value[0]:
                h[hole] = h[parent]
                hole = parent
                parent = (hole - 1) >> 1
            h[hole] = value

        for _, s, payload in items:
            if len(heap) < max_map:
                heap.append((s, payload))
                push(heap)
            elif s > heap[0][0]:
                pop(heap)
                heap[-1] = (s, payload)
                push(heap)
        return [p for _, p in heap]

    def _gap_descriptors(self, j, read_len, is_rev, cq, ct, cl,
                         chr_beg, chr_end):
        """Descriptor list for the plain-path DP sites of one window
        (left end / inter-seed gaps / right end), mirroring the stitcher's
        call sites (native/stitch.cpp; reference src/LordFAST.cpp:1820-2230).
        Query coordinates are rebased onto the forward read row: the
        strand-oriented query is revcomp(fwd) for reverse windows, so a
        slice [a, a+n) of it is the reverse-complemented slice
        [L-a-n, L-a) of the forward row, and a site-level revcomp (left
        end) cancels the strand one."""
        slack = self.cfg.end_extension_slack
        L = read_len
        n = len(cq)

        def q_adj(a, ln, site_rc):
            if is_rev:
                return L - a - ln, not site_rc
            return a, site_rc

        descs = []  # (slot, q_start, q_len, q_rc, t_start, t_len, t_rc, shw)
        r0 = int(cq[0])
        tl0 = r0 + slack
        if r0 > 0 and int(ct[0]) - tl0 >= chr_beg:
            qa, qrc = q_adj(0, r0, True)
            descs.append((0, j, qa, r0, qrc, int(ct[0]) - tl0, tl0, True,
                          True))
        for i in range(n - 1):
            r_s = int(cq[i] + cl[i])
            t_s = int(ct[i] + cl[i])
            rl = int(cq[i + 1]) - r_s
            tl = int(ct[i + 1]) - t_s
            if rl > 0 and tl > 0:
                qa, qrc = q_adj(r_s, rl, False)
                descs.append((i + 1, j, qa, rl, qrc, t_s, tl, False, False))
        r_s = int(cq[n - 1] + cl[n - 1])
        rl = L - r_s
        tl = rl + slack
        if rl > 0 and int(ct[n - 1] + cl[n - 1]) + tl - 1 <= chr_end:
            qa, qrc = q_adj(r_s, rl, False)
            descs.append((n, j, qa, rl, qrc, int(ct[n - 1] + cl[n - 1]), tl,
                          False, True))
        return descs

    def _run_gap_descs(self, items, reads_dev):
        """Batched device Myers DP over arbitrary gap descriptors:
        dispatch + blocking collect (see _dispatch_gap_descs)."""
        return self._collect_gap_descs(
            self._dispatch_gap_descs(items, reads_dev)
        )

    def _dispatch_gap_descs(self, items, reads_dev, want_moves=True):
        """Asynchronously dispatch the batched device Myers DP over
        arbitrary gap descriptors.

        want_moves=False: fetch only (dist, end) per gap — the stitcher
        reconstructs each PATH with the bit-exact edlib banded traceback
        (native edlib_path.cpp) from the known distance, which both
        closes the band-edge tie divergence the in-kernel unbanded
        traceback had AND drops the per-column colcode transfer from the
        device fetch.

        items: list of (key, desc) with desc = (row_j, q_start, q_len,
        q_rc, t_start, t_len, t_rc, is_shw) in forward-read-row / global
        genome coordinates (see _gap_descriptors).  Buckets by padded
        size and dispatches all sub-batches without blocking; the
        returned pending list feeds _collect_gap_descs, whose ONE
        blocking device_get can then overlap the next batch's host work.
        Descriptors larger than every bucket are omitted (the native
        stitcher computes those locally)."""
        cfg = self.cfg
        buckets = cfg.gap_buckets
        per_bucket = [[] for _ in buckets]
        n_host = 0
        want_hist = cfg.verbosity >= 2  # hoisted out of the hot loop
        gsz_hist = {}
        for key, d in items:
            q_len, t_len = d[2], d[5]
            if want_hist:
                m = 1 << max(max(q_len, t_len) - 1, 0).bit_length()
                gsz_hist[m] = gsz_hist.get(m, 0) + 1
            for bi, (Q, T, _) in enumerate(buckets):
                if q_len <= Q and t_len <= T:
                    per_bucket[bi].append((key, d))
                    break
            else:
                n_host += 1
        if want_hist:
            for m, cnt in gsz_hist.items():
                self.metrics.add(f"gsz_{m}", cnt)
        if n_host:
            self.metrics.add("gaps_host", n_host)

        pending = []  # ("cols", parts, merged_arrays, gps) | ("plain", ...)
        t_pack = time.time()
        for bi, per in enumerate(per_bucket):
            if not per:
                continue
            Q, T, G = buckets[bi]
            self.metrics.add(f"gaps_b{Q}", len(per))
            # a new (gap bucket x read-length bucket) shape pays its JIT
            # trace+compile synchronously on first dispatch; book that
            # under gap_compile, not gap_pack (steady-state metric)
            shape_key = (Q, T, tuple(reads_dev.shape))
            bparts = []  # GapColsResult parts of THIS bucket, merged below
            for s in range(0, len(per), G):
                part = per[s : s + G]
                g = len(part)
                # one C-level conversion instead of 8*g Python item writes
                dmat = np.asarray([d for _, d in part], dtype=np.int64)
                desc = {
                    "q_read": np.zeros(G, np.int32),
                    "q_start": np.zeros(G, np.int32),
                    "q_len": np.ones(G, np.int32),
                    "q_rc": np.zeros(G, bool),
                    "t_start": np.zeros(G, np.int64),
                    "t_len": np.ones(G, np.int32),
                    "t_rc": np.zeros(G, bool),
                    "is_shw": np.zeros(G, bool),
                    "valid": np.zeros(G, bool),
                }
                desc["q_read"][:g] = dmat[:, 0]
                desc["q_start"][:g] = dmat[:, 1]
                desc["q_len"][:g] = dmat[:, 2]
                desc["q_rc"][:g] = dmat[:, 3] != 0
                desc["t_start"][:g] = dmat[:, 4]
                desc["t_len"][:g] = dmat[:, 5]
                desc["t_rc"][:g] = dmat[:, 6] != 0
                desc["is_shw"][:g] = dmat[:, 7] != 0
                desc["valid"][:g] = True
                t_d = time.time()
                # gather and DP kernel dispatched as separate jits: the
                # gather recompiles per read-batch length bucket (cheap);
                # the kernel compiles once per (Q, T) gap bucket
                qs_d, ql_d, ts_d, tl_d = gap_dp.gather_gap_seqs_jit(
                    self.arrs["pac_words"], reads_dev, desc, Q, T,
                    self.meta["l_pac"],
                )
                if gap_dp_pallas.kernel_for(self._backend, Q, T) == "pallas":
                    res = gap_dp_pallas.gap_align_pl(
                        qs_d, ql_d, ts_d, tl_d, desc["is_shw"], Q, T,
                        with_path=want_moves,
                    )
                else:
                    if self._backend == "gpu":  # bucket the kernel skips
                        self.metrics.add("gap_jnp_fallback", len(part))
                    res = gap_dp.gap_align(
                        qs_d, ql_d, ts_d, tl_d, desc["is_shw"], Q, T
                    )
                if shape_key not in self._gap_shapes_seen:
                    self._gap_shapes_seen.add(shape_key)
                    dt = time.time() - t_d
                    self.metrics.timers["gap_compile"] += dt
                    t_pack += dt  # exclude compile from gap_pack
                if not want_moves:
                    # dist/end only (GapColsResult and GapResult both
                    # carry .dist/.end)
                    gp = 128 * ((len(part) + 127) // 128)
                    gp = min(gp, G)
                    bparts.append((part, res, gp, 0))
                elif isinstance(res, gap_dp_pallas.GapColsResult):
                    # row/lane trim bounds: used lanes padded to a lane
                    # tile, rows to the part's deepest target
                    gp = 128 * ((len(part) + 127) // 128)
                    tp = 8 * ((int(desc["t_len"][: len(part)].max()) + 7)
                              // 8)
                    bparts.append((part, res, min(gp, G),
                                   min(tp, res.colcode.shape[0])))
                else:
                    pending.append(("plain", [part], res, [len(part)]))
            if bparts:
                # merge the bucket's parts into ONE array quartet on
                # device: the blocking device_get fetches arrays one
                # round-trip each, so 4 arrays per BUCKET instead of 4
                # per PART.  Lanes are trimmed per part and rows to the
                # bucket-wide max before the concat.
                import jax.numpy as jnp

                tp = max(x[3] for x in bparts)
                parts = [x[0] for x in bparts]
                gps = [x[2] for x in bparts]
                if not want_moves:
                    if len(bparts) == 1:
                        _, res, gp, _ = bparts[0]
                        merged = (res.dist[:gp], res.end[:gp])
                    else:
                        merged = (
                            jnp.concatenate(
                                [r.dist[:gp] for _, r, gp, _ in bparts]),
                            jnp.concatenate(
                                [r.end[:gp] for _, r, gp, _ in bparts]),
                        )
                    pending.append(("dist", parts, merged, gps))
                elif len(bparts) == 1:
                    _, res, gp, _ = bparts[0]
                    merged = (res.dist[:gp], res.end[:gp], res.lead[:gp],
                              res.colcode[:tp, :gp])
                    pending.append(("cols", parts, merged, gps))
                else:
                    merged = (
                        jnp.concatenate(
                            [r.dist[:gp] for _, r, gp, _ in bparts]),
                        jnp.concatenate(
                            [r.end[:gp] for _, r, gp, _ in bparts]),
                        jnp.concatenate(
                            [r.lead[:gp] for _, r, gp, _ in bparts]),
                        jnp.concatenate(
                            [r.colcode[:tp, :gp]
                             for _, r, gp, _ in bparts], axis=1),
                    )
                    pending.append(("cols", parts, merged, gps))

        # final cross-bucket merge: ONE array set for the whole dispatch
        # — the blocking collect then costs one fetch round-trip per
        # array total instead of per bucket
        cols = [p for p in pending if p[0] == "cols"]
        dist_only = [p for p in pending if p[0] == "dist"]
        rest = [p for p in pending if p[0] not in ("cols", "dist")]
        if len(cols) > 1 or len(dist_only) > 1:
            import jax.numpy as jnp

            pending = list(rest)
            if len(cols) == 1:
                pending.append(cols[0])
            elif cols:
                meta = []  # (parts, gps, tp_rows, lane_width) per bucket
                for _, parts, (d, e, ld, cc), gps in cols:
                    meta.append((parts, gps, cc.shape[0], cc.shape[1]))
                merged = (
                    jnp.concatenate([m[2][0] for m in cols]),
                    jnp.concatenate([m[2][1] for m in cols]),
                    jnp.concatenate([m[2][2] for m in cols]),
                    jnp.concatenate([m[2][3].ravel() for m in cols]),
                )
                pending.append(("colsx", meta, merged, None))
            if len(dist_only) == 1:
                pending.append(dist_only[0])
            elif dist_only:
                meta = [(parts, gps) for _, parts, _, gps in dist_only]
                merged = (
                    jnp.concatenate([m[2][0] for m in dist_only]),
                    jnp.concatenate([m[2][1] for m in dist_only]),
                )
                pending.append(("distx", meta, merged, None))

        self.metrics.timers["gap_pack"] += time.time() - t_pack
        return pending

    def _collect_gap_descs(self, pending):
        """Blocking half of _run_gap_descs: fetch every dispatched
        sub-batch in one device_get and expand the per-column codes into
        move arrays.  Returns {key: (dist, end, moves)}."""
        results = {}
        if pending:
            import jax

            t_wait = time.time()
            fetched = jax.device_get(
                [tuple(r) if kind == "plain" else r
                 for kind, _, r, _ in pending]
            )
            self.metrics.timers["gap_wait"] += time.time() - t_wait
            t_unpack = time.time()
            for (kind, parts, _, gps), vals in zip(pending, fetched):
                if kind == "dist":
                    dist_a, end_a = vals
                    off = 0
                    for part, gp in zip(parts, gps):
                        for gi, (key, d) in enumerate(part):
                            results[key] = (int(dist_a[off + gi]),
                                            int(end_a[off + gi]), None)
                        off += gp
                    continue
                if kind == "distx":
                    dist_a, end_a = vals
                    ga = 0
                    for bparts, bgps in parts:
                        for part, gp in zip(bparts, bgps):
                            for gi, (key, d) in enumerate(part):
                                results[key] = (int(dist_a[ga + gi]),
                                                int(end_a[ga + gi]),
                                                None)
                            ga += gp
                    continue
                if kind == "colsx":
                    dist_a, end_a, lead_a, colflat = vals
                    ga = 0   # lane offset into dist/end/lead
                    fo = 0   # element offset into the flat colcode
                    for bparts, bgps, tp, width in parts:
                        colcode = colflat[fo : fo + tp * width].reshape(
                            tp, width
                        )
                        fo += tp * width
                        off = ga
                        for part, gp in zip(bparts, bgps):
                            g = len(part)
                            sl = slice(off, off + g)
                            moves = gap_dp_pallas.decode_col_moves(
                                colcode[:, off - ga : off - ga + g],
                                end_a[sl], lead_a[sl]
                            )
                            for gi, (key, d) in enumerate(part):
                                results[key] = (int(dist_a[off + gi]),
                                                int(end_a[off + gi]),
                                                moves[gi])
                            off += gp
                        ga += width
                    continue
                if kind == "cols":
                    dist, end, lead, colcode = vals  # colcode: (tp, sumG)
                    off = 0
                    for part, gp in zip(parts, gps):
                        g = len(part)
                        sl = slice(off, off + g)
                        moves = gap_dp_pallas.decode_col_moves(
                            colcode[:, sl], end[sl], lead[sl]
                        )
                        for gi, (key, d) in enumerate(part):
                            results[key] = (int(dist[off + gi]),
                                            int(end[off + gi]), moves[gi])
                        off += gp
                else:
                    (part,) = parts
                    g = len(part)
                    dist, end, packed, _mlen = vals
                    moves = gap_dp.unpack_moves(packed[:g], _mlen[:g])
                    for gi, (key, d) in enumerate(part):
                        results[key] = (int(dist[gi]), int(end[gi]),
                                        moves[gi])
            self.metrics.timers["gap_unpack"] += time.time() - t_unpack
        return results

    def _precompute_gaps(self, jobs, reads_dev):
        """Batched device gap-DP over every plain-path DP site of every
        selected window in the batch (SURVEY.md §7 step 5), assembled
        into per-window gap tables consumed by the native stitcher.
        Dispatch and collect are split so the blocking collect of batch
        k can overlap the host work of batch k+1 (software pipeline in
        _map_chunk)."""
        return self._collect_jobs_gaps(
            jobs, self._dispatch_jobs_gaps(jobs, reads_dev)
        )

    def _dispatch_jobs_gaps(self, jobs, reads_dev):
        items = [
            ((job_id, d[0]), d[1:])
            for job_id, job in enumerate(jobs)
            for d in job["descs"]
        ]
        # dist/end only: the stitcher reconstructs each path with the
        # bit-exact edlib banded traceback (native edlib_path.cpp)
        return self._dispatch_gap_descs(items, reads_dev,
                                        want_moves=False)

    def _collect_jobs_gaps(self, jobs, pending):
        results = self._collect_gap_descs(pending)

        tables = {}
        for (job_id, slot), (dist, end, moves) in results.items():
            t = tables.get(job_id)
            if t is None:
                ns = len(jobs[job_id]["cq"]) + 1
                t = {
                    "has": np.zeros(ns, np.uint8),
                    "dist": np.zeros(ns, np.int64),
                    "end": np.zeros(ns, np.int64),
                    "len": np.zeros(ns, np.int64),
                    "mv": [None] * ns,
                }
                tables[job_id] = t
            t["has"][slot] = 1
            t["dist"][slot] = dist
            t["end"][slot] = end
            # moves None = dist/end only; len -1 tells the stitcher to
            # reconstruct the path locally (banded-exact, stitch.cpp)
            t["len"][slot] = -1 if moves is None else len(moves)
            t["mv"][slot] = moves

        # concatenate per-job move buffers with offsets
        out = {}
        for job_id, t in tables.items():
            ns = len(t["has"])
            off = np.zeros(ns, np.int64)
            bufs = []
            pos = 0
            for slot in range(ns):
                if t["has"][slot] and t["mv"][slot] is not None:
                    off[slot] = pos
                    bufs.append(t["mv"][slot])
                    pos += len(t["mv"][slot])
            mvbuf = (np.concatenate(bufs) if bufs
                     else np.zeros(0, np.uint8))
            out[job_id] = (t["has"], t["dist"], t["end"], mvbuf, off,
                           t["len"])
        return out

    # escalation sub-slot indices (per gap slot; stitch.cpp esc_* ABI)
    ESC_KSW1, ESC_KSW2, ESC_NW_A, ESC_NW_IF, ESC_NW_IR, ESC_NW_B = range(6)

    @staticmethod
    def _sub_view(start, length, rc, a, L, extra_rc):
        """Global (start, rc) of slice [a, a+L) of the oriented view
        (start, length, rc), optionally reverse-complemented again."""
        if rc:
            return start + length - a - L, (not extra_rc)
        return start + a, extra_rc

    def _run_affine_descs(self, items, reads_dev):
        """Batched device ksw_extend2 over escalation descriptors.

        items: list of (key, desc8, kind) with desc8 = (row, qa, qn, qrc,
        ta, tn, trc, shw) and kind in {"clip", "split"} selecting the
        reference's parameter set (src/LordFAST.cpp:1848 vs :1971).
        Returns {key: (score, qle, tle)}; oversized sites are omitted
        (the stitcher runs them locally)."""
        cfg = self.cfg
        w_max = max(cfg.clip_band, cfg.split_band)
        BW = 128 * ((2 * w_max + 2 + 127) // 128)
        per = [[] for _ in cfg.affine_buckets]
        n_host = 0
        for it in items:
            qn, tn = it[1][2], it[1][5]
            for bi, (Qe, Te, _) in enumerate(cfg.affine_buckets):
                if qn <= Qe and tn <= Te:
                    per[bi].append(it)
                    break
            else:
                n_host += 1
        if n_host:
            self.metrics.add("esc_host", n_host)

        pending = []
        for bi, group in enumerate(per):
            if not group:
                continue
            Qe, Te, G = cfg.affine_buckets[bi]
            self.metrics.add(f"esc_b{Qe}", len(group))
            for s in range(0, len(group), G):
                part = group[s : s + G]
                desc = {
                    "q_read": np.zeros(G, np.int32),
                    "q_start": np.zeros(G, np.int32),
                    "q_len": np.ones(G, np.int32),
                    "q_rc": np.zeros(G, bool),
                    "t_start": np.zeros(G, np.int64),
                    "t_len": np.ones(G, np.int32),
                    "t_rc": np.zeros(G, bool),
                    "is_shw": np.zeros(G, bool),
                    "valid": np.zeros(G, bool),
                    "o_del": np.ones(G, np.int32),
                    "e_del": np.ones(G, np.int32),
                    "o_ins": np.ones(G, np.int32),
                    "e_ins": np.ones(G, np.int32),
                    "w_eff": np.ones(G, np.int32),
                    "zdrop": np.zeros(G, np.int32),
                    "h0": np.ones(G, np.int32),
                    "match": np.full(G, cfg.ksw_match_clip, np.int32),
                    "mismatch": np.full(G, cfg.ksw_mismatch_clip,
                                        np.int32),
                }
                from ..ops import affine_pl

                for gi, (key, d8, kind) in enumerate(part):
                    (row, qa, qn, qrc, ta, tn, trc, _s) = d8
                    desc["q_read"][gi] = row
                    desc["q_start"][gi] = qa
                    desc["q_len"][gi] = qn
                    desc["q_rc"][gi] = qrc
                    desc["t_start"][gi] = ta
                    desc["t_len"][gi] = tn
                    desc["t_rc"][gi] = trc
                    desc["valid"][gi] = True
                    if kind == "clip":
                        od = oi = cfg.ksw_gap_open_clip
                        ed_ = ei = cfg.ksw_gap_extend_clip
                        w, zd = cfg.clip_band, cfg.clip_zdrop
                    else:
                        od, ed_ = cfg.split_o_del, cfg.split_e_del
                        oi, ei = cfg.split_o_ins, cfg.split_e_ins
                        w, zd = cfg.split_band, cfg.split_zdrop
                    desc["o_del"][gi] = od
                    desc["e_del"][gi] = ed_
                    desc["o_ins"][gi] = oi
                    desc["e_ins"][gi] = ei
                    desc["zdrop"][gi] = zd
                    desc["h0"][gi] = qn
                    desc["w_eff"][gi] = affine_pl.clamp_band(
                        qn, cfg.ksw_match_clip, 0, od, ed_, oi, ei, w
                    )
                # split gather / kernel jits (same rationale as the
                # Myers path: kernel compiles once per bucket)
                qs_d, ql_d, ts_d, tl_d = gap_dp.gather_gap_seqs_jit(
                    self.arrs["pac_words"], reads_dev, desc, Qe, Te,
                    self.meta["l_pac"],
                )
                res = affine_pl.extend_batch(
                    qs_d, ts_d, Qe, Te, BW, w_max, qlen=ql_d, tlen=tl_d,
                    o_del=desc["o_del"], e_del=desc["e_del"],
                    o_ins=desc["o_ins"], e_ins=desc["e_ins"],
                    w_eff=desc["w_eff"], zdrop=desc["zdrop"],
                    h0=desc["h0"], match=desc["match"],
                    mismatch=desc["mismatch"],
                )
                pending.append((part, res))

        results = {}
        if pending:
            import jax

            t_wait = time.time()
            fetched = jax.device_get([tuple(r) for _, r in pending])
            self.metrics.timers["esc_wait"] += time.time() - t_wait
            for (part, _), vals in zip(pending, fetched):
                score, qle, tle = vals[0], vals[1], vals[2]
                for gi, (key, d8, kind) in enumerate(part):
                    results[key] = (int(score[gi]), int(qle[gi]),
                                    int(tle[gi]))
        return results

    def _escalation_pass(self, jobs, tables, reads_dev):
        """Device offload of the clip / split escalation DPs.

        Phase B: replay the stitcher's escalation decisions (float32 sim
        arithmetic; src/LordFAST.cpp:1846,1952) against the plain-path
        gap results, batching every flagged site into the device affine
        extension.  Phase C: the secondary NW segments the affine ends imply
        (clip-trimmed prefix, split part1/part2, inversion middle,
        src/LordFAST.cpp:1850,1998-2093,2034-2077) run through the
        batched Myers kernel.  Every result is exact vs the stitcher's
        local DP, so partial coverage is safe — the stitcher computes any
        missing piece itself."""
        cfg = self.cfg
        E = self  # sub-slot constants
        aff = []
        for job_id, job in enumerate(jobs):
            tab = tables.get(job_id)
            if tab is None:
                continue
            has, dist = tab[0], tab[1]
            for d in job["descs"]:
                slot = d[0]
                if not has[slot]:
                    continue
                d8 = d[1:]
                q_len, t_len, shw = d8[2], d8[5], d8[7]
                sim = float(np.float32(1.0)
                            - np.float32(int(dist[slot]))
                            / np.float32(q_len))
                if shw:
                    if q_len > cfg.clip_len and sim < cfg.clip_sim:
                        aff.append(((job_id, slot, E.ESC_KSW1), d8,
                                    "clip"))
                elif (abs(q_len - t_len) >= cfg.split_len
                      and sim < cfg.split_sim):
                    aff.append(((job_id, slot, E.ESC_KSW1), d8, "split"))
                    (row, qa, qn, qrc, ta, tn, trc, _s) = d8
                    aff.append(((job_id, slot, E.ESC_KSW2),
                                (row, qa, qn, not qrc, ta, tn, not trc,
                                 _s), "split"))
        if not aff:
            return {}
        self.metrics.add("esc_sites", len(aff))
        with self.metrics.timer("esc_affine"):
            aff_res = self._run_affine_descs(aff, reads_dev)

        # ---- phase C: secondary NW descriptors ----
        def nw_desc(d8, qa_off, qL, qX, ta_off, tL, tX):
            (row, qa, qn, qrc, ta, tn, trc, _s) = d8
            q2, qrc2 = self._sub_view(qa, qn, qrc, qa_off, qL, qX)
            t2, trc2 = self._sub_view(ta, tn, trc, ta_off, tL, tX)
            return (row, q2, qL, qrc2, t2, tL, trc2, False)

        by_site = {}
        for key, d8, kind in aff:
            job_id, slot, sub = key
            by_site.setdefault((job_id, slot), {})[sub] = (d8, kind)
        nw_items = []
        esc_vals = {}  # key -> (a, b) for the ksw subs
        for (job_id, slot), subs in by_site.items():
            d8, kind = subs[E.ESC_KSW1]
            q_len, t_len = d8[2], d8[5]
            k1 = (job_id, slot, E.ESC_KSW1)
            if k1 not in aff_res:
                continue
            _, qle1, tle1 = aff_res[k1]
            esc_vals[k1] = (qle1, tle1)
            if kind == "clip":
                if 0 < qle1 < q_len and tle1 >= 1:
                    nw_items.append(((job_id, slot, E.ESC_NW_A),
                                     nw_desc(d8, 0, qle1, False, 0, tle1,
                                             False)))
                continue
            k2 = (job_id, slot, E.ESC_KSW2)
            if k2 not in aff_res:
                continue
            _, qle2, tle2 = aff_res[k2]
            esc_vals[k2] = (qle2, tle2)
            if not (qle1 < q_len - qle2 or tle1 < t_len - tle2):
                continue  # degenerate split: stitcher takes plain path
            if qle1 >= 1 and tle1 >= 1:
                nw_items.append(((job_id, slot, E.ESC_NW_A),
                                 nw_desc(d8, 0, qle1, False, 0, tle1,
                                         False)))
            mid_r = q_len - qle1 - qle2
            mid_t = t_len - tle1 - tle2
            if mid_r > 0 and mid_t > 0:
                nw_items.append(((job_id, slot, E.ESC_NW_IF),
                                 nw_desc(d8, qle1, mid_r, False, tle1,
                                         mid_t, False)))
                nw_items.append(((job_id, slot, E.ESC_NW_IR),
                                 nw_desc(d8, qle1, mid_r, True, tle1,
                                         mid_t, False)))
            if qle2 >= 1 and tle2 >= 1:
                nw_items.append(((job_id, slot, E.ESC_NW_B),
                                 nw_desc(d8, q_len - qle2, qle2, True,
                                         t_len - tle2, tle2, True)))
        nw_res = self._run_gap_descs(nw_items, reads_dev) if nw_items \
            else {}

        # ---- assemble per-job escalation tables ----
        esc = {}
        def etab(job_id):
            t = esc.get(job_id)
            if t is None:
                ns = (len(jobs[job_id]["cq"]) + 1) * 6
                t = {"has": np.zeros(ns, np.uint8),
                     "a": np.zeros(ns, np.int64),
                     "b": np.zeros(ns, np.int64),
                     "mv": [None] * ns}
                esc[job_id] = t
            return t

        for (job_id, slot, sub), (a, b) in esc_vals.items():
            t = etab(job_id)
            i = slot * 6 + sub
            t["has"][i] = 1
            t["a"][i] = a
            t["b"][i] = b
        for (job_id, slot, sub), (dist, _end, moves) in nw_res.items():
            t = etab(job_id)
            i = slot * 6 + sub
            t["has"][i] = 1
            t["a"][i] = dist
            t["b"][i] = len(moves)
            t["mv"][i] = moves

        out = {}
        for job_id, t in esc.items():
            ns = len(t["has"])
            off = np.zeros(ns, np.int64)
            bufs = []
            pos = 0
            for i in range(ns):
                if t["mv"][i] is not None:
                    off[i] = pos
                    bufs.append(t["mv"][i])
                    pos += len(t["mv"][i])
            mvbuf = (np.concatenate(bufs) if bufs
                     else np.zeros(0, np.uint8))
            out[job_id] = (t["has"], t["a"], t["b"], mvbuf, off)
        return out

    def _stitch_job(self, job, gap_table, esc_table) -> Mapping:
        # thread-pool worker: must not touch shared mutable state
        # (metrics are accounted serially by the caller)
        return align_and_score(
            job["cq"], job["ct"], job["cl"], job["query"], job["read_len"],
            job["is_rev"], self.idx, self.cfg, gap_table=gap_table,
            esc_table=esc_table,
        )

    def _stitch_all(self, jobs, tables, esc_tables) -> List[Mapping]:
        """Stitch every selected window of the batch, across host threads
        when a pool exists (reference parity: one worker per core,
        src/LordFAST.cpp:305-316; --threads / cfg.num_threads)."""
        if self._pool is not None and len(jobs) > 1:
            mappings = list(
                self._pool.map(
                    lambda it: self._stitch_job(it[1], tables.get(it[0]),
                                                esc_tables.get(it[0])),
                    enumerate(jobs),
                )
            )
        else:
            mappings = [
                self._stitch_job(job, tables.get(jid),
                                 esc_tables.get(jid))
                for jid, job in enumerate(jobs)
            ]
        for job, m in zip(jobs, mappings):
            if len(m.records) > 1:
                self.metrics.add("splits", len(m.records) - 1)
                base = 16 if job["is_rev"] else 0
                self.metrics.add(
                    "inversions",
                    sum(1 for r in m.records if (r.flag & 16) != base),
                )
        return mappings

    # ---- main loop ----
    def map_file(self, seq_path, out: TextIO, command_line: str = "",
                 progress: Optional[ChunkProgress] = None,
                 process_index: int = 0, num_processes: int = 1):
        """Map every read of seq_path, writing SAM to out.

        progress: optional chunk-level checkpoint (SURVEY.md §5.4) — chunks
        with id <= progress.last_done are skipped (already in the output of
        a previous run); each completed chunk is recorded durably.

        process_index / num_processes: multi-host sharding — this process
        maps only chunks with chunk_id % num_processes == process_index
        (the DCN analogue of the reference's independent chunks,
        src/baseFAST.cpp:64-78; parallel/multihost.py merges the per-host
        shards).  self.chunk_table records (chunk_id, byte_start,
        byte_end) per completed chunk for the ordered merge."""
        cfg = self.cfg
        # fresh counters/timers per run (chunk lines report deltas)
        self.metrics.reset()
        self.chunk_table = []
        resume_from = progress.last_done if progress else -1
        if resume_from >= 0:
            # seed cumulative stats from the sidecar so run totals and
            # the mapped-rate remain correct across resumes
            self.stats["reads"] = progress.total_reads
            self.stats["mapped"] = progress.total_mapped
        if not cfg.no_sam_header and resume_from < 0:
            sam_io.write_header(out, self.idx, cfg, command_line)

        def _tell():
            try:
                out.flush()
                return out.tell()
            except (OSError, AttributeError):
                return 0

        for chunk_id, chunk in enumerate(read_chunks(seq_path,
                                                     cfg.chunk_bytes)):
            if chunk_id % num_processes != process_index:
                continue
            if chunk_id <= resume_from:
                self.metrics.log(
                    1, f"[engine] chunk {chunk_id} already done; skipping"
                )
                continue
            t0 = time.time()
            self.stats["chunks"] += 1
            self.metrics.snapshot()
            c_start = _tell()
            self._map_chunk(chunk, out)
            self.chunk_table.append((chunk_id, c_start, _tell()))
            if progress is not None:
                out.flush()
                try:
                    off = out.tell()
                except (OSError, AttributeError):
                    off = 0
                progress.mark_done(chunk_id, out_offset=off,
                                   total_reads=self.stats["reads"],
                                   total_mapped=self.stats["mapped"])
            print(
                "[engine] "
                + self.metrics.chunk_line(chunk_id, len(chunk),
                                          time.time() - t0),
                file=sys.stderr, flush=True,
            )
        if progress is not None:
            progress.finish()

    def _map_chunk(self, chunk: List[Read], out: TextIO):
        import jax

        cfg = self.cfg

        # short reads are emitted unmapped without touching the device
        # (src/LordFAST.cpp:490-499); over-long reads likewise — the
        # reference has no guard and overflows its SEQ_MAX_LENGTH=250k
        # stack buffers (src/Common.h:51), this build rejects them cleanly
        def in_range(r):
            return cfg.min_read_len <= len(r.seq) <= cfg.seq_max_length

        n_long = sum(1 for r in chunk if len(r.seq) > cfg.seq_max_length)
        if n_long:
            self.metrics.add("overlong_reads", n_long)
            self.metrics.log(
                0, f"[WARNING] {n_long} read(s) longer than "
                   f"{cfg.seq_max_length} bp emitted unmapped",
            )
        work = [r for r in chunk if in_range(r)]
        # length-bucketed batches to bound padding waste
        order = sorted(range(len(work)), key=lambda i: len(work[i].seq))
        results = {}
        B = cfg.batch_reads

        def dispatch(s):
            idxs = order[s : s + B]
            batch = [work[i] for i in idxs]
            self.stats["batches"] += 1
            L = _pad_to_bucket(max(len(r.seq) for r in batch))
            # pad the batch dimension to a fixed B so XLA compiles once
            # per length bucket, not once per (bucket, batch-size) pair
            arr = np.full((B, L), 4, dtype=np.uint8)
            lens = np.zeros(B, dtype=np.int32)
            for j, r in enumerate(batch):
                codes = seq_to_codes(r.seq)
                arr[j, : len(codes)] = codes
                lens[j] = len(codes)
            # ship reads once; the same device buffer feeds the seeding
            # stage and the gap-DP gathers (no second upload)
            reads_dev = self._put_reads(arr)
            seeds_np = (self._host_seeds(arr, lens)
                        if cfg.seeder != "extend-whole" else None)
            _, chains_dev, host_out = self._device_stage(
                reads_dev, lens, host_seeds=seeds_np
            )
            return (idxs, batch, reads_dev, lens, (chains_dev, host_out),
                    seeds_np)

        def _rows_by_read(out):
            rows = {}
            cw_valid = out["cw_valid"]
            cw_read = out["cw_read_idx"]
            for k in range(len(cw_valid)):
                if cw_valid[k]:
                    rows.setdefault(int(cw_read[k]), []).append(k)
            return rows

        def resolve(idxs, batch, reads_dev, lens, dev, seeds_np=None):
            # one device->host transfer per batch, trimmed on device
            # (seeds and full chains stay on device)
            chains_dev, host_out = dev
            with self.metrics.timer("device"):
                out = jax.device_get(host_out)
            for name in ("seeds", "candidates", "fine_reads",
                         "chained_windows"):
                self.metrics.add(name, int(out[f"stat_{name}"]))
            t_sel = time.time()
            rows_by_read = _rows_by_read(out)

            # window selection pre-pass: find chains exceeding the eager
            # transfer cap and fetch them all in one gather roundtrip
            # selections[j] = (is_fine, [(ctx_id, row), ...])
            selections = {}
            overflow = []
            for j in range(len(idxs)):
                is_fine, selected, over = self._select_rows(
                    j, out, rows_by_read
                )
                selections[j] = (is_fine, [(0, k) for k in selected])
                if over:
                    overflow.append(j)

            # per-read device context: 0 = normal run, 1 = 8x-budget
            # retry, 2+ = solo 512-window retries (and their candidate-
            # rank pages) for reads whose windows overflowed the shared
            # K compact slots
            ctxs = [(out, chains_dev)]
            if overflow:
                self.metrics.add("compact_retry", len(overflow))
                with self.metrics.timer("device"):
                    _, chains2, host_out2 = self._device_stage(
                        reads_dev, lens, big=True, host_seeds=seeds_np
                    )
                    out2 = jax.device_get(host_out2)
                rows2 = _rows_by_read(out2)
                ctxs.append((out2, chains2))
                for j in overflow:
                    is_fine, selected, over2 = self._select_rows(
                        j, out2, rows2
                    )
                    selections[j] = (is_fine, [(1, k) for k in selected])
                    if over2:
                        # still no slots: run the read alone with a
                        # 512-window budget (solo row 0 in its context)
                        self.metrics.add("compact_solo", 1)
                        codes_j = seq_to_codes(batch[j].seq)
                        L_j = reads_dev.shape[1]
                        with self.metrics.timer("device"):
                            out3, chains3 = self._solo_retry(codes_j,
                                                             L_j)
                        rows3 = _rows_by_read(out3)
                        is_fine, selected, over3 = self._select_rows(
                            0, out3, rows3
                        )
                        ctxs.append((out3, chains3))
                        ci3 = len(ctxs) - 1
                        selections[j] = (is_fine,
                                         [(ci3, k) for k in selected])
                        if over3 and is_fine:
                            # >512 qualifying windows: page through the
                            # further candidate-rank windows until a
                            # page is unsaturated, then heap-select over
                            # the union — the reference chains EVERY
                            # qualifying window (src/LordFAST.cpp:874-904)
                            pairs = [(ci3, k) for k in rows3.get(0, [])]
                            sat, p = True, 1
                            while sat and p < 64:
                                self.metrics.add("compact_page", 1)
                                with self.metrics.timer("device"):
                                    outp, chainsp = self._solo_retry(
                                        codes_j, L_j, page=p
                                    )
                                rowsp = _rows_by_read(outp)
                                ctxs.append((outp, chainsp))
                                cip = len(ctxs) - 1
                                pairs += [(cip, k)
                                          for k in rowsp.get(0, [])]
                                sat = bool(outp["cand_sat"][0])
                                p += 1
                            if sat:  # >32k qualifying windows
                                self.stats["compact_overflow"] = (
                                    self.stats.get("compact_overflow",
                                                   0) + 1
                                )
                                self.metrics.log(
                                    1, "[WARNING] window paging hit the"
                                       " 64-page cap; selection may be "
                                       "truncated",
                                )
                            sel = self._fine_heap_select_multi(
                                pairs, ctxs, cfg.max_map
                            )
                            selections[j] = (is_fine, sel)
                        elif over3:
                            self.stats["compact_overflow"] = (
                                self.stats.get("compact_overflow", 0) + 1
                            )
                            self.metrics.log(
                                1, "[WARNING] read slot overflow after "
                                   "solo retry; emitted unmapped",
                            )

            self.metrics.timers["py_select"] += time.time() - t_sel
            lazy = []
            ncap = out["chain_ql"].shape[1]
            for j in range(len(idxs)):
                is_fine, selected = selections[j]
                for ci, k in selected:
                    if ci != 0:
                        continue  # retry rows fetch directly (rare)
                    n = int(out["chain_len"][k])
                    if n > ncap:
                        lazy.append((k, n))
            wide = None
            if lazy:
                with self.metrics.timer("device"):
                    wide = self._fetch_wide_rows(
                        chains_dev, [k for k, _ in lazy],
                        max(n for _, n in lazy),
                    )

            # stitch-job construction per read
            t_jb = time.time()
            jobs = []
            read_jobs = {}  # batch row -> (is_fine, [job ids or None])
            for j, i in enumerate(idxs):
                read = batch[j]
                read_len = len(read.seq)
                is_fine, selected = selections[j]
                slots = []
                fwd = rev = None
                for ci, k in selected:
                    out_j, chains_j = ctxs[ci]
                    wide_j = wide if ci == 0 else None
                    n = int(out_j["chain_len"][k])
                    if n <= 1:
                        slots.append(None)  # unmapped placeholder
                        continue
                    if fwd is None:
                        fwd = seq_to_codes(read.seq)
                        rev = revcomp_codes(fwd)
                    is_rev = bool(out_j["cw_is_rev"][k])
                    cq, ct, cl = self._chain_rows(out_j, chains_j, k, n,
                                                  wide_j)
                    chr_beg, chr_end = self.idx.chr_boundaries(
                        int(ct[0]), int(ct[n - 1])
                    )
                    job = {
                        "cq": cq, "ct": ct, "cl": cl,
                        "query": rev if is_rev else fwd,
                        "read_len": read_len, "is_rev": is_rev,
                    }
                    job["descs"] = self._gap_descriptors(
                        j, read_len, is_rev, cq, ct, cl, chr_beg, chr_end
                    )
                    slots.append(len(jobs))
                    jobs.append(job)
                read_jobs[j] = (is_fine, slots)
            self.metrics.timers["py_jobbuild"] += time.time() - t_jb

            # dispatch the gap DPs asynchronously; the blocking collect
            # happens in finish() one pipeline step later, overlapping
            # this wait with the NEXT batch's host-side work
            with self.metrics.timer("gap_dp"):
                pending = self._dispatch_jobs_gaps(jobs, reads_dev)
            return (idxs, batch, jobs, read_jobs, reads_dev, pending)

        def finish(ctx):
            idxs, batch, jobs, read_jobs, reads_dev, pending = ctx
            with self.metrics.timer("gap_dp"):
                tables = self._collect_jobs_gaps(jobs, pending)

            esc_tables = {}
            if self._esc_device:
                with self.metrics.timer("esc_dp"):
                    esc_tables = self._escalation_pass(jobs, tables,
                                                       reads_dev)

            with self.metrics.timer("stitch"):
                mappings_by_job = self._stitch_all(jobs, tables,
                                                   esc_tables)

            for j, i in enumerate(idxs):
                read_len = len(batch[j].seq)
                is_fine, slots = read_jobs[j]
                mappings = [
                    mappings_by_job[s] if s is not None
                    else Mapping(records=[], total_score=-2 * read_len)
                    for s in slots
                ]
                # fine mode: sort by totalScore (compareSam,
                # src/LordFAST.cpp:986)
                if is_fine:
                    mappings.sort(key=lambda m: -m.total_score)
                results[i] = mappings

        # two-level software pipeline: up to `depth` device batches in
        # flight (host work of batch k overlaps device compute of k+1;
        # JAX dispatch is async, device_get is the sync point), plus a
        # one-step stage split inside each batch — resolve() ends at the
        # async gap-DP dispatch, finish() starts at its blocking collect
        # — so the gap-kernel wait of batch k overlaps the host
        # selection/job-assembly of batch k+1
        depth = 2
        inflight = []
        staged = []
        for s in range(0, len(order), B):
            inflight.append(dispatch(s))
            if len(inflight) > depth:
                staged.append(resolve(*inflight.pop(0)))
                if len(staged) > 1:
                    finish(staged.pop(0))
        for item in inflight:
            staged.append(resolve(*item))
            if len(staged) > 1:
                finish(staged.pop(0))
        for ctx in staged:
            finish(ctx)

        with self.metrics.timer("emit"):
            wi = 0
            for r in chunk:
                self.stats["reads"] += 1
                if not in_range(r):
                    sam_io.emit_read(
                        out, self.idx, cfg, r.name, r.seq, r.qual, []
                    )
                    continue
                mappings = results[wi]
                wi += 1
                if mappings and mappings[0].records:
                    self.stats["mapped"] += 1
                sam_io.emit_read(
                    out, self.idx, cfg, r.name, r.seq, r.qual, mappings
                )

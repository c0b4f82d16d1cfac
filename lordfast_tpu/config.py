"""Single frozen configuration for the whole engine.

Mirrors every knob of the reference CLI (defaults from
``src/CommandLineParser.cpp:32-55``) plus every compile-time constant that
the reference hardcodes (``src/LordFAST.cpp:70-92``, ``src/BWT.cpp:34``,
``src/Common.h:51``, ``src/baseFAST.cpp:59``), plus the device-batching
knobs that have no reference equivalent (padded-shape budgets).

The device budgets below keep their earlier values; none has been tuned
on the H100 yet (PERF.md lists what has been measured there).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


class ChainAlg:
    """Chaining algorithm selector (reference ``src/Common.h:56``)."""

    CLASP = "clasp"
    DPN2 = "dp-n2"


@dataclass(frozen=True)
class LordfastConfig:
    # ---- reference CLI options (src/CommandLineParser.cpp:32-55) ----
    min_anchor_len: int = 14        # -k/--minAnchorLen, valid [12..20]
    sampling_count: int = 1000      # -c/--anchorCount
    max_map: int = 10               # -n/--numMap
    min_read_len: int = 1000        # -l/--minReadLen (floor 100)
    max_ref_hits: int = 1000        # -m/--maxRefHit
    chain_alg: str = ChainAlg.DPN2  # -a/--chainAlg
    chain_reward: float = 9.3       # -r/--chainReward
    chain_penalty: float = 11.4     # -p/--chainPenalty
    gap_penalty: float = 0.15       # -g/--gapPenalty
    read_group: str = ""            # -R/--readGroup (escaped line)
    read_group_id: str = ""         # parsed ID: field
    no_sam_header: bool = False     # --noSamHeader
    output_buffer_size: int = 2_000_000  # opt_outputBufferSize

    # ---- reference compile-time constants ----
    seq_max_length: int = 250_000   # src/Common.h:51
    chunk_bytes: int = 100_000_000  # src/baseFAST.cpp:59
    kmer_cache_k: int = 12          # kCache, src/BWT.cpp:34
    score_ratio: float = 4.0        # scoreRatio, src/LordFAST.cpp:542
    # ksw scoring (src/LordFAST.cpp:78-85)
    ksw_match: int = 2
    ksw_mismatch: int = 5
    ksw_gap_open: int = 2
    ksw_gap_extend: int = 1
    ksw_match_clip: int = 2
    ksw_mismatch_clip: int = 16
    ksw_gap_open_clip: int = 0
    ksw_gap_extend_clip: int = 1
    # split/clip/inversion thresholds (src/LordFAST.cpp:88-92)
    clip_len: int = 500
    clip_sim: float = 0.75
    split_len: int = 80
    split_sim: float = 0.40
    reverse_sim: float = 0.60
    # end-extension reference slack (src/LordFAST.cpp:1822,2160)
    end_extension_slack: int = 20
    # split-escalation ksw_extend2 parameters (src/LordFAST.cpp:1971)
    split_o_del: int = 8
    split_e_del: int = 1
    split_o_ins: int = 4
    split_e_ins: int = 1
    split_band: int = 100
    split_zdrop: int = 200
    # clip-escalation ksw_extend parameters (src/LordFAST.cpp:1848)
    clip_band: int = 40
    clip_zdrop: int = 40
    # clasp chaining constants (src/Chain.cpp:50-57)
    clasp_lambda: float = 0.15
    clasp_epsilon: float = 0.0

    # ---- index layout ----
    occ_interval: int = 128         # bases per Occ checkpoint block
    # SA sampling interval.  0 = auto: store the FULL suffix array
    # (interval 1) when it fits sa_mem_budget bytes — locate becomes a
    # single gather instead of an up-to-interval-step inverse-Psi walk
    # (one random gather per step) — else fall back to 32 (bwa's choice,
    # bwtindex.c:286).
    sa_interval: int = 0
    sa_mem_budget: int = 2 << 30    # device bytes the SA may occupy

    # chaining DP score dtype.  "auto" (default) = f64 everywhere, which
    # reproduces the reference's double arithmetic (the only residual is
    # the backend's f64 log vs libm).  "f32" is available for
    # experiments; it can flip score-tied window rankings (~1 read in 60
    # on the test fixture).
    chain_dp_dtype: str = "auto"

    # ---- device batching budgets (no reference equivalent: the reference
    # allocates SAMPLING_COUNT*MAX_REF_HITS per-thread seed buffers; we
    # bound the padded per-read seed tensor instead) ----
    max_seeds_per_read: int = 4096  # flat (tPos,qPos,len) slots per strand
    # staged anchor extension (ops/fm_index.py): run phase1_steps, resolve
    # occ==1 lanes by direct text comparison, compact the remaining alive
    # lanes to BS/compact_frac, and repeat with /3 smaller caps until the
    # tail runs to completion; the occ==1 resolution is what makes the
    # early compaction safe
    seed_phase1_steps: int = 6
    seed_compact_frac: int = 16
    # windows chained in fine mode per read.  48 keeps cand_sat (the
    # per-read candidate-cap saturation that forces the 8x-budget device
    # retry, pipeline/engine.py) from firing on repeat-dense batches —
    # the reference has no per-read cap below its heap size
    # (src/LordFAST.cpp:874-904), so a larger C is MORE reference-parity
    # and removes a second full device pass per batch (VERDICT r4 #3)
    max_candidates: int = 48
    compact_windows_per_read: int = 8  # avg chaining slots per read (K = B*this)
    max_chain_seeds: int = 512      # seeds entering the chaining DP / window
    # chaining DP bucketing (ops/chain.py _chain_bucketed): every window
    # runs a chain_small_n-wide DP; only the top chain_big_windows by
    # seed count also run the full max_chain_seeds-wide DP (exact merge)
    chain_small_n: int = 64
    chain_big_windows: int = 128
    chain_transfer_cap: int = 160   # chain slots copied to host eagerly
    # reads per device batch (padding waste against per-dispatch cost)
    batch_reads: int = 128
    # device gap-DP bucket shapes (ops/gap_dp.py): (Q, T, G) = padded
    # query len (mult of 32), padded target len ((Q+T) mult of 16), gaps
    # per kernel invocation.  A gap uses the first bucket with
    # q_len <= Q and t_len <= T; bigger gaps run on the host (rare).
    # tuned to the PacBio-CLR gap-size distribution (sampling_count=1000
    # seeds give dense anchors, so most inter-seed gaps are <=64 bp; the
    # tail buckets catch end extensions and sparse-chain windows).
    # The asymmetric buckets catch SV-deletion-shaped gaps (tiny query,
    # kilobase target): Myers cost scales with T * (Q/32), so a
    # narrow-query bucket affords a deep target.
    # The final (4096, 4352) bucket covers every gap the bench/SV
    # datasets produce — gaps_host stays 0; anything even larger (a
    # >4 kb unanchored region inside one window) falls back to the host
    # stitcher, whose nw_align is the banded edlib-exact path at
    # O((d/64)*tl) with Hirschberg above 1 MB (native/edlib_path.cpp) —
    # arbitrary sizes, like the reference.
    # G sized so a typical 128-read batch needs 1-2 parts per bucket
    # (one kernel launch and one fetch per part)
    gap_buckets: tuple = ((32, 48, 8192), (64, 96, 4096),
                          (128, 160, 4096), (256, 320, 2048),
                          (512, 576, 1024), (32, 4096, 512),
                          (64, 2304, 512), (128, 1152, 512),
                          (2048, 2176, 64), (4096, 4352, 32))
    # device affine-extension bucket shapes (ops/affine_pl.py):
    # (Qe, Te, G) padded query/target lengths and problems per call for
    # the clip/split escalation ksw_extend2 kernel; larger escalation
    # sites run on the host inside the stitcher (rare monster clips)
    affine_buckets: tuple = ((512, 544, 128), (2048, 2080, 128),
                             (8192, 8224, 128))

    # ---- seeder variant ----
    # "extend-whole" = the reference's ACTIVE seeder
    # (getLocs_extend_whole_step, src/BWT.cpp:312-394; the device kernel
    # in ops/fm_index.py).  The two dormant variants the reference ships
    # but never calls (src/BWT.cpp:423-591) are available as host
    # implementations (ops/seeders.py): "extend-whole-2" (maximal
    # leftward extension from sampled END positions) and
    # "extend-whole-3" (longest-match-starting-at-i table).
    seeder: str = "extend-whole"

    # ---- runtime ----
    num_threads: int = 0            # host worker threads (0 = auto)
    # runtime verbosity: replaces the reference's compile-time VERBOSITY
    # levels 0-3 (src/Common.h:33-49, Makefile:3-8); level 1 = per-chunk
    # stage counters, 2 = per-read candidates/chains, 3 = per-gap DP
    verbosity: int = 0

    def validate(self) -> "LordfastConfig":
        """Range checks mirroring src/CommandLineParser.cpp:274-293."""
        if not (12 <= self.min_anchor_len <= 20):
            raise ValueError("-k/--minAnchorLen requires an argument in [12..20]")
        if self.sampling_count <= 0:
            raise ValueError("-c/--anchorCount requires a positive integer")
        if self.max_map <= 0:
            raise ValueError("-n/--numMap requires a positive integer")
        if self.max_ref_hits <= 0:
            raise ValueError("-m/--maxRefHit requires a positive integer")
        cfg = self
        if cfg.min_read_len < 100:  # floor, CommandLineParser.cpp:194
            cfg = dataclasses.replace(cfg, min_read_len=100)
        if cfg.chain_alg not in (ChainAlg.CLASP, ChainAlg.DPN2):
            cfg = dataclasses.replace(cfg, chain_alg=ChainAlg.DPN2)
        return cfg

    def replace(self, **kw) -> "LordfastConfig":
        return dataclasses.replace(self, **kw)

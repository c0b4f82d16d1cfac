"""Multi-device scale-out: data parallelism over reads.

The reference's only parallelism is a pthread pool over reads
(src/LordFAST.cpp:305-316); the device equivalent is sharding the
read-batch axis across the devices of a plain ("data",) mesh with the
FM-index replicated (SURVEY.md §2.5, §5.8).  All device stages (seeding,
voting, window seed selection, chaining) are batched on axis 0, so a
NamedSharding on that axis partitions the whole pipeline; XLA inserts no
cross-device collectives on the hot path (the index is replicated;
per-read state never crosses devices).

For genome-scale sharded-index operation see parallel/sharded_index.py:
interval-routed Occ lookups, whose collectives XLA hands to NCCL.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import chain as chain_ops
from ..ops import fm_index as fm_ops
from ..ops import voting as vote_ops


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), axis_names=("data",))


def device_pipeline(meta, cfg):
    """The full device stage as one pure jittable function of
    (arrs, reads, lens, pos).  meta/cfg are closed over (static).

    The index arrays are an *argument* pytree, not a closure: closed-over
    concrete arrays are baked into the HLO as constants, which bloats the
    executable for genome-scale indexes (hundreds of MB)."""
    meta_t = tuple(sorted((k, v) for k, v in meta.items()
                          if k != "pos_dtype"))

    def fn(arrs, reads, lens, pos, page=None):
        with jax.named_scope("lf_seed"):
            seeds = fm_ops._seed_anchors_impl(
                arrs, reads, lens, pos, meta_t,
                cfg.sampling_count, cfg.min_anchor_len, cfg.max_ref_hits,
                cfg.max_seeds_per_read, cfg.seed_phase1_steps,
                cfg.seed_compact_frac,
            )
        return post_seed_stage(arrs, seeds, reads, lens, cfg, page)

    return fn


def _need_mask(cands, cfg):
    """Which candidates need chaining (compact_candidates' criterion,
    ops/chain.py:59-67)."""
    C = cands.cnt.shape[1]
    cidx = jnp.arange(C, dtype=jnp.int32)[None, :]
    return cands.valid & jnp.where(
        cands.is_fine[:, None],
        cands.cnt.astype(jnp.float32) > cands.min_score[:, None],
        cidx == 0,
    )


def post_seed_stage(arrs, seeds, reads, lens, cfg, page=None):
    """Everything after seeding (voting, selection, chaining, host-payload
    trimming) — shared by the replicated and sharded-index pipelines.
    These stages are pure per-read, so they shard over the read axis with
    no collectives regardless of where the seeds came from.

    page: optional traced int32 candidate-rank page (see
    vote_windows); the engine's window paging for reads whose
    qualifying windows exceed one pipeline budget."""
    with jax.named_scope("lf_vote"):
        cands = vote_ops.vote_windows(seeds, lens, cfg, page)
    k_windows = reads.shape[0] * cfg.compact_windows_per_read
    with jax.named_scope("lf_select"):
        cw = chain_ops.compact_candidates(cands, cfg, k_windows)
        ws = chain_ops.select_window_seeds(seeds, cw, lens, arrs, cfg)
    with jax.named_scope("lf_chain"):
        chains = chain_ops.chain_seeds(ws, cfg)

    # Host-bound results, trimmed on device: the chains tensor
    # (K x N x 3 words) is cut to the first chain_transfer_cap slots with (qPos, len)
    # packed into one int32 (qPos < 2^18 given SEQ_MAX_LENGTH=250k,
    # len < 2^12 given the 12-bit Seed_t.len field).  Chains longer
    # than the cap (rare, ultra-long reads) are fetched lazily from
    # the full on-device tensor.
    ncap = min(cfg.chain_transfer_cap, chains.q_pos.shape[-1])
    packed = (chains.q_pos[:, :ncap].astype(jnp.int32) << 12) | (
        chains.length[:, :ncap].astype(jnp.int32)
    )
    host_out = {
        # per-batch stage counters, reduced on device (SURVEY.md §5.5)
        "stat_seeds": seeds.n_total.astype(jnp.int32).sum(),
        "stat_candidates": cands.valid.sum().astype(jnp.int32),
        # mask padding rows (lens == 0): their empty vote tables can
        # classify as "fine" and inflate the counter
        "stat_fine_reads": (cands.is_fine & (lens > 0)).sum().astype(
            jnp.int32
        ),
        "stat_chained_windows": (chains.chain_len > 1).sum().astype(
            jnp.int32
        ),
        "cand_valid0": cands.valid[:, 0],
        "is_fine": cands.is_fine,
        # per-read window demand, for overflow detection on the host:
        # how many candidates qualify for chaining (fine: cnt > minScore,
        # coarse: the top window; compact_candidates' need mask), and
        # whether the per-read candidate cap C itself may be truncating
        # (the last, lowest-vote candidate still qualifies)
        "cand_need": _need_mask(cands, cfg).sum(axis=1).astype(jnp.int32),
        "cand_sat": _need_mask(cands, cfg)[:, -1],
        "cw_read_idx": cw.read_idx,
        "cw_cand_idx": cw.cand_idx,
        "cw_win_id": cw.win_id,
        "cw_is_rev": cw.is_rev,
        "cw_valid": cw.valid,
        "chain_len": chains.chain_len,
        "chain_score": chains.score,
        "chain_t": chains.t_pos[:, :ncap],
        "chain_ql": packed,
    }
    return seeds, chains, host_out


def sharded_pipeline(idx, cfg, mesh: Mesh):
    """jit the device pipeline with the read axis sharded over the mesh
    and the index replicated."""
    repl = NamedSharding(mesh, P())
    shard0 = NamedSharding(mesh, P("data"))
    arrs = idx.device_arrays(sharding=repl)
    fn = device_pipeline(idx.meta, cfg)
    jitted = jax.jit(
        fn,
        in_shardings=(None, shard0, shard0, shard0),
        out_shardings=None,
    )
    return functools.partial(jitted, arrs)

"""Sharded-index mode: the FM-index striped across the devices of a mesh.

The replicated mode (parallel/mesh.py) keeps a full copy of the index in
every device's memory — the analogue of the reference's single in-process
``bwaidx_t`` shared by all threads (src/BWT.cpp:32).  At GRCh38 scale the
rank structures stop fitting comfortably (full-SA locate alone is
8 B x 6.2e9 rows = 50 GB), so this module shards the three large arrays
by rows over the mesh and routes every rank / SA lookup to the owning
shard (SURVEY.md §5.8; semantics of lib/bwa/bwt.c:107-166 unchanged):

- ``fm_blocks`` (or ``occ_cp`` + ``bwt_blocks``): 128-base rank blocks,
- ``bwt_words``: the 2-bit BWT stream (inverse-Psi walk when sa_intv>1),
- ``sa_samp``: the (possibly full) sampled suffix array.

Routing pattern (ops/fm_index.py ``_row_gather``): all-gather the query
row ids over the mesh axis, each shard answers the rows it owns with a
local gather (zeros elsewhere), and a reduce-scatter (psum_scatter)
returns to each device exactly its own queries' answers.  Reads stay
data-parallel on the same axis, so each backward-search step costs one
(D, n)-int all-gather plus one reduce-scatter over the interconnect — amortized over
batch_reads x sampling_count lanes in lockstep.

Small arrays stay replicated: L2 (40 B), contig tables, the 4^k k-mer
cache (268 MB at k=12) and ``pac_words`` (l_pac/4 bytes; the gap-DP
reference fetches are strided slices, which routing would serialize).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import fm_index as fm_ops
from .mesh import post_seed_stage

# arrays striped by rows over the mesh; everything else is replicated
_SHARDED_KEYS = ("fm_blocks", "occ_cp", "bwt_blocks", "bwt_words",
                 "sa_samp")


def shard_index_arrays(idx, mesh: Mesh, axis: str = "data",
                       specs_only: bool = False):
    """Device placement for sharded-index mode.

    Returns (arrs, specs): the device array dict (same keys the kernels
    use) and a matching dict of PartitionSpecs.  Large arrays are padded
    to a row multiple of the mesh size and placed P(axis); the rest P().
    specs_only: skip the device_put, return (None, specs).
    """
    D = mesh.shape[axis]
    host = idx.host_arrays()
    if specs_only:
        specs = {k: (P(axis) if k in _SHARDED_KEYS else P())
                 for k in host}
        return None, specs
    repl = NamedSharding(mesh, P())
    row = NamedSharding(mesh, P(axis))
    arrs, specs = {}, {}
    for k, v in host.items():
        if k in _SHARDED_KEYS:
            n = v.shape[0]
            pad = (-n) % D
            if pad:
                v = np.concatenate(
                    [v, np.zeros((pad,) + v.shape[1:], v.dtype)]
                )
            arrs[k] = jax.device_put(v, row)
            specs[k] = P(axis)
        else:
            arrs[k] = jax.device_put(v, repl)
            specs[k] = P()
    return arrs, specs


def sharded_index_pipeline(idx, cfg, mesh: Mesh, axis: str = "data",
                           arrs=None, paged: bool = False):
    """The full device stage with the index sharded over ``axis``.

    Seeding runs under shard_map with interval-routed rank/locate
    collectives; voting / selection / chaining are pure per-read and run
    data-parallel exactly as in the replicated pipeline.  Returns
    (fn, arrs) where fn(arrs, reads, lens, pos) ->
    (seeds, chains, host_out) matches the replicated pipeline
    bit-for-bit.

    arrs: already-sharded index arrays from a previous call — reuse them
    instead of device_put-ting a second HBM copy (engine overflow-retry
    pipeline)."""
    meta_t = tuple(sorted((k, v) for k, v in idx.meta.items()
                          if k != "pos_dtype"))
    if arrs is None:
        arrs, specs = shard_index_arrays(idx, mesh, axis)
    else:
        _, specs = shard_index_arrays(idx, mesh, axis, specs_only=True)
    shard0 = NamedSharding(mesh, P(axis))

    def seed_local(a, reads, lens, pos):
        return fm_ops._seed_anchors_impl(
            a, reads, lens, pos, meta_t,
            cfg.sampling_count, cfg.min_anchor_len, cfg.max_ref_hits,
            cfg.max_seeds_per_read, cfg.seed_phase1_steps,
            cfg.seed_compact_frac, axis=axis,
        )

    seed_sharded = jax.shard_map(
        seed_local,
        mesh=mesh,
        in_specs=(specs, P(axis), P(axis), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )

    def fn(a, reads, lens, pos, page=None):
        with jax.named_scope("lf_seed_sharded"):
            seeds = seed_sharded(a, reads, lens, pos)
        return post_seed_stage(a, seeds, reads, lens, cfg, page)

    if paged:
        jitted = jax.jit(
            lambda a, r, ln, p, page: fn(a, r, ln, p, page),
            in_shardings=(None, shard0, shard0, shard0, None),
        )
    else:
        jitted = jax.jit(fn, in_shardings=(None, shard0, shard0, shard0))
    return jitted, arrs

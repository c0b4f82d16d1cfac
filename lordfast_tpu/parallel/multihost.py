"""Multi-process scale-out: per-process read shards + SAM shard merge.

The reference is single-node, but its chunked driver loop is already the
right decomposition for hosts: each ~100 MB chunk is independent
(src/baseFAST.cpp:64-78), so hosts simply own disjoint chunk ids of the
shared input (round-robin: chunk_id % num_processes == process_index) and
write their own SAM shard — the analogue of the reference's independent
chunks, with no cross-process traffic on the mapping path (SURVEY.md
§5.8).  Each process opens one card of its host: a JAX process reserves
most of a card's memory at start-up, so a second process on the same
card would fail.  An optional ordered merge concatenates the per-host
shards back into one SAM in input (chunk) order, which the reference
cannot do (its output order is thread-nondeterministic).

jax.distributed is only needed when a *global* mesh spans processes or
for the end-of-run barrier before the rank-0 merge;
``maybe_init_distributed`` gates it behind explicit coordinator
configuration.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

_DIST_INITIALIZED = False


def maybe_init_distributed(coordinator: str, num_processes: int,
                           process_index: int) -> bool:
    """Restrict this process to card ``process_index`` of its host and
    start jax.distributed when a coordinator is given.  Must run before
    the JAX backend starts.  Returns True when the distributed runtime
    is (now) up."""
    global _DIST_INITIALIZED
    if _DIST_INITIALIZED:
        return True
    import jax

    if not coordinator:
        jax.config.update("jax_cuda_visible_devices", str(process_index))
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_index,
        local_device_ids=[process_index],
    )
    _DIST_INITIALIZED = True
    return True


def barrier(name: str = "lordfast") -> None:
    """Cross-host sync point (no-op when distributed is not initialized)."""
    if not _DIST_INITIALIZED:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def shard_path(out_path: str | os.PathLike, process_index: int) -> str:
    return f"{out_path}.part{process_index}"


def chunks_path(out_path: str | os.PathLike) -> str:
    return f"{out_path}.chunks"


def write_chunk_table(out_path: str | os.PathLike, table) -> None:
    """Persist the per-chunk byte ranges of one SAM shard
    ([(chunk_id, byte_start, byte_end), ...], engine.chunk_table)."""
    tmp = f"{chunks_path(out_path)}.tmp"
    with open(tmp, "w") as f:
        json.dump({"chunks": [list(c) for c in table]}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, chunks_path(out_path))


def merge_shards(out_path: str | os.PathLike, num_processes: int,
                 keep_parts: bool = False) -> int:
    """Ordered merge of per-host SAM shards into ``out_path``.

    Each shard carries a ``.chunks`` sidecar with its chunk byte ranges;
    the merge emits the header of shard 0 followed by every chunk in
    ascending chunk-id order.  Returns the number of chunks merged.
    """
    parts = [Path(shard_path(out_path, i)) for i in range(num_processes)]
    tables = []
    for p in parts:
        rec = json.loads(Path(chunks_path(p)).read_text())
        tables.append([tuple(c) for c in rec["chunks"]])

    all_chunks = sorted(
        (cid, pi, s, e)
        for pi, tbl in enumerate(tables)
        for cid, s, e in tbl
    )
    with open(out_path, "wb") as out:
        # header = shard 0's bytes before its first chunk
        hdr_end = tables[0][0][1] if tables[0] else parts[0].stat().st_size
        with open(parts[0], "rb") as f:
            out.write(f.read(hdr_end))
        for cid, pi, s, e in all_chunks:
            with open(parts[pi], "rb") as f:
                f.seek(s)
                out.write(f.read(e - s))
    if not keep_parts:
        for p in parts:
            p.unlink(missing_ok=True)
            Path(chunks_path(p)).unlink(missing_ok=True)
    return len(all_chunks)

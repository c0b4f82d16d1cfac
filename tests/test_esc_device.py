"""Device escalation offload (engine._escalation_pass + the jnp affine
extension + stitch.cpp esc table): the SAM output with the offload
enabled must be byte-identical to the host-local escalation path (the
default) on the golden fixture, which contains split / inversion / clip /
garbage reads (tests/make_fixtures.py append_structured_reads)."""

import io
from pathlib import Path

import pytest

from lordfast_tpu.config import LordfastConfig
from lordfast_tpu.pipeline.engine import MappingEngine

DATA = Path(__file__).parent / "data"

TEST_CFG = dict(
    kmer_cache_k=8,
    max_seeds_per_read=1024,
    max_chain_seeds=128,
    max_candidates=16,
)


@pytest.fixture(scope="module")
def esc_index():
    from lordfast_tpu.index.builder import build_index

    return build_index(DATA / "ref.fa", LordfastConfig(kmer_cache_k=8),
                       verbose=False)


@pytest.fixture(scope="module")
def sv_reads():
    from lordfast_tpu.io.fastx import read_chunks

    chunk = next(read_chunks(DATA / "reads.fq", 10**9))
    # the escalation-heavy tail + a few normal reads
    return [r for r in chunk
            if r.name.startswith(("sv_", "garbage"))] + chunk[:6]


def _map(idx, reads, esc_device):
    eng = MappingEngine(idx, LordfastConfig(**TEST_CFG),
                        esc_device=esc_device)
    out = io.StringIO()
    eng._map_chunk(reads, out)
    return out.getvalue(), eng


def test_esc_device_sam_identical(esc_index, sv_reads):
    sam_local, _ = _map(esc_index, sv_reads, esc_device=False)
    sam_dev, eng = _map(esc_index, sv_reads, esc_device=True)
    assert eng.metrics.counters.get("esc_sites", 0) > 0, (
        "escalation offload never fired — test reads no longer exercise it"
    )
    assert sam_dev == sam_local

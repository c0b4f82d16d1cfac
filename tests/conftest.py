"""Test configuration: force an 8-device CPU mesh before JAX initializes
so pjit/shard_map paths are exercised without a card (SURVEY.md §4).
Tests that need a card carry the `gpu` marker and run it in a child
process (see tests/test_gpu.py)."""

import os

# both the environment and the config: a child process inherits the first
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (runs chip_smoke.py phases in a child "
        "process; skipped where no card exists)",
    )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def ref12_idx():
    """The tests/data/ref.fa index with the reference's k=12 cache,
    disk-cached across suite runs (tests/data/ref.fa.* is gitignored):
    the 4^12 cache BFS costs ~70 s and test_bwa_io used to build it
    twice per run (VERDICT r4 weak #6)."""
    from pathlib import Path

    from lordfast_tpu.config import LordfastConfig
    from lordfast_tpu.index.builder import (build_index, load_index,
                                            save_index)

    data = Path(__file__).parent / "data"
    p = data / "ref.fa.lft.npz"
    if p.exists():
        try:
            return load_index(p)
        except Exception:
            p.unlink()
    idx = build_index(data / "ref.fa", LordfastConfig(), verbose=False)
    save_index(idx, p)
    return idx


@pytest.fixture(scope="session")
def ref8_idx():
    """tests/data/ref.fa at the fast k=8 test cache, shared across the
    engine/golden/multihost modules (identical mapping results — cache
    depth only affects how many backward steps are skipped)."""
    from pathlib import Path

    from lordfast_tpu.config import LordfastConfig
    from lordfast_tpu.index.builder import build_index

    data = Path(__file__).parent / "data"
    return build_index(data / "ref.fa", LordfastConfig(kmer_cache_k=8),
                       verbose=False)


@pytest.fixture(scope="session")
def small_index():
    """A small random-genome FM index shared across tests."""
    from lordfast_tpu.config import LordfastConfig
    from lordfast_tpu.index.builder import build_index
    import tempfile

    r = np.random.default_rng(7)
    contigs = {
        "chrA": r.integers(0, 4, size=20011),
        "chrB": r.integers(0, 4, size=9973),
    }
    with tempfile.NamedTemporaryFile("w", suffix=".fa", delete=False) as f:
        for name, codes in contigs.items():
            f.write(f">{name}\n")
            seq = "".join("ACGT"[c] for c in codes)
            for i in range(0, len(seq), 70):
                f.write(seq[i : i + 70] + "\n")
        path = f.name
    cfg = LordfastConfig(kmer_cache_k=6)
    idx = build_index(path, cfg, verbose=False)
    return idx, contigs

"""Process and device set-up that the CPU can check: where the compile
cache goes, which card each mapping process opens, the gap-kernel
dispatch in the engine, and chip_smoke.py refusing to run without a GPU
or outside a checkout."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


def _child(code, **env_over):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR",
                        "XLA_FLAGS")}
    env.update(env_over)
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().splitlines()[-1]


CACHE_PROBE = (
    "import lordfast_tpu, jax; c = jax.config; "
    "print(c.jax_enable_compilation_cache, c.jax_compilation_cache_dir)"
)


@pytest.mark.parametrize("case", ["default", "env_dir", "cpu"])
def test_compile_cache_placement(case, tmp_path):
    if case == "default":      # no env: <checkout>/.jax_cache
        out = _child(CACHE_PROBE)
        assert out == f"True {ROOT / '.jax_cache'}"
    elif case == "env_dir":    # JAX_COMPILATION_CACHE_DIR wins, untouched
        out = _child(CACHE_PROBE, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
        assert out == f"True {tmp_path}"
    else:                      # XLA:CPU never uses the persistent cache
        out = _child(CACHE_PROBE, JAX_PLATFORMS="cpu",
                     JAX_COMPILATION_CACHE_DIR=str(tmp_path))
        assert out.startswith("False ")


@pytest.mark.parametrize("proc", [0, 3])
def test_process_opens_only_its_card(proc):
    # --numProcesses 4 --processIndex i: process i sees card i only; with
    # no coordinator the restriction is set before the backend starts,
    # through the config jax.distributed uses for local_device_ids
    out = _child(
        "import jax, sys; from lordfast_tpu.cli import main; "
        "import lordfast_tpu.parallel.multihost as mh; "
        "mh.shard_path = lambda *a: sys.exit("
        "print(jax.config.values['jax_cuda_visible_devices'])); "
        f"main(['--search', 'r.fa', '--seq', 'r.fq', '-o', 'o.sam', "
        f"'--numProcesses', '4', '--processIndex', '{proc}'])")
    assert out == str(proc)


TEST_CFG = dict(kmer_cache_k=8, max_seeds_per_read=1024, max_chain_seeds=128,
                max_candidates=16)

# (row, q_start, q_len, q_rc, t_start, t_len, t_rc, is_shw)
DESCS = [(0, 10, 20, False, 100, 25, False, False),
         (1, 0, 50, True, 500, 60, False, True),
         (0, 200, 700, False, 4000, 2600, True, False)]


def _gap_results(idx, backend):
    import jax

    from lordfast_tpu.config import LordfastConfig
    from lordfast_tpu.pipeline.engine import MappingEngine

    eng = MappingEngine(idx, LordfastConfig(**TEST_CFG))
    eng._backend = backend
    reads = np.random.default_rng(0).integers(0, 4, (2, 1024), np.uint8)
    items = [((i, 0), d) for i, d in enumerate(DESCS)]
    return eng._run_gap_descs(items, jax.device_put(reads)), eng


def test_gpu_shape_fallback_is_counted(ref8_idx, monkeypatch):
    # on the GPU a bucket the kernel does not serve runs the jnp kernel
    # and is counted, not hidden; results equal the CPU path's
    from lordfast_tpu.ops import gap_dp_pallas

    want, eng_cpu = _gap_results(ref8_idx, "cpu")
    monkeypatch.setattr(gap_dp_pallas, "supports", lambda Q, T: False)
    got, eng_gpu = _gap_results(ref8_idx, "gpu")
    assert eng_gpu.metrics.counters["gap_jnp_fallback"] == len(DESCS)
    assert "gap_jnp_fallback" not in eng_cpu.metrics.counters
    assert got.keys() == want.keys()
    for k in want:
        assert got[k][:2] == want[k][:2]
        np.testing.assert_array_equal(got[k][2], want[k][2])


def test_engine_rejects_unknown_backend(ref8_idx, monkeypatch):
    import jax

    from lordfast_tpu.config import LordfastConfig
    from lordfast_tpu.pipeline.engine import MappingEngine

    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(ValueError, match="backend"):
        MappingEngine(ref8_idx, LordfastConfig(**TEST_CFG))


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    # CPU-only machine: non-zero exit, no result line; a directory that
    # holds chip_smoke.py and nothing else of the repo: the same
    if where == "checkout":
        script, cwd = ROOT / "chip_smoke.py", ROOT
    else:
        script = tmp_path / "chip_smoke.py"
        shutil.copy(ROOT / "chip_smoke.py", script)
        cwd = tmp_path
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout

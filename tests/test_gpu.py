"""Checks that need the card.  The pytest session is held to the CPU
(conftest.py), so each runs a chip_smoke.py phase in a child process
that opens the GPU; where no card exists they skip.  On a machine with a
card: `python -m pytest -m gpu tests/`."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def gpu_env():
    """Environment for a child that opens the card; skips without one."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        pytest.skip("no nvidia-smi: no NVIDIA GPU on this machine")
    r = subprocess.run([smi, "-L"], capture_output=True, text=True)
    if r.returncode != 0 or "GPU" not in r.stdout:
        pytest.skip("nvidia-smi lists no GPU")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.gpu
def test_kernels_compiled_on_card(gpu_env):
    """The Myers kernel and the affine extension, compiled for the card,
    exact against gap_dp.gap_align and the host oracles at every bucket
    (chip_smoke.py phases 1-2)."""
    r = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--kernels-only"],
        cwd=ROOT, env=gpu_env, capture_output=True, text=True, timeout=1200,
    )
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"

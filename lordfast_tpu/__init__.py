"""lordfast_tpu: a long-read alignment engine on a GPU, written in JAX.

A from-scratch reimplementation of the capabilities of lordFAST
(vpc-ccg/lordfast; Haghshenas, Sahinalp, Hach, Bioinformatics 2018) built
on JAX/XLA/Pallas:

- FM-index anchoring as batched device kernels (reference:
  ``src/BWT.cpp:312-394``),
- window voting / candidate selection as sparse segment ops
  (``src/LordFAST.cpp:582-904``),
- seed chaining (dp-n2 / clasp-SOP semantics) as masked scans
  (``src/Chain.cpp``),
- Myers bit-parallel and affine-gap banded DP extension as batched
  device kernels (``lib/edlib/edlib.cpp``, ``lib/bwa/ksw.c``),
- SAM emission on the host, equivalent to the reference
  (``src/LordFAST.cpp:318-459``).

Reads are the data-parallel axis across devices; the index is replicated
(or sharded for genome-scale deployments).  Host code handles sequential
I/O (FASTA/FASTQ parsing, index construction, SAM formatting).

64-bit positions: genome coordinates for human-scale references exceed
2**31 (the concatenated fwd+revcomp text is ~6.2e9 bases), so this package
enables jax_enable_x64 at import.  All kernels pick int32/int64 explicitly
based on the index size, so small-genome paths still run in 32-bit.
"""

import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the device stage is one large jitted
# function compiled once per read-length bucket, plus one gap kernel per
# bucket.  Where JAX_COMPILATION_CACHE_DIR is set, JAX already uses it and
# nothing is set here; otherwise the cache lives in <checkout>/.jax_cache.
# XLA:CPU is excluded: reloading a cached CPU executable can hard-abort
# the process in this JAX build (machine-feature mismatch, "Fatal Python
# error: Aborted" with no message), so CPU processes always compile fresh.
_plat = _os.environ.get("JAX_PLATFORMS", "").strip()
# a process may also force CPU programmatically before importing this
# package (jax.config.update("jax_platforms", "cpu")) — honor both
_plat_cfg = (getattr(_jax.config, "jax_platforms", None) or "").strip()
if "cpu" in (_plat, _plat_cfg):
    _jax.config.update("jax_enable_compilation_cache", False)
elif "JAX_COMPILATION_CACHE_DIR" not in _os.environ:
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"),
    )
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

__version__ = "0.1.0"

from .config import LordfastConfig  # noqa: E402,F401

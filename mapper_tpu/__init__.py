"""mapper_tpu — a batched read-alignment and variant-summarization engine.

A from-scratch reimplementation of the capabilities of X-Mapper
(mathjeff/Mapper 1.2.2, Java) designed around batched device scoring:

- reference indexing uses the same deterministic, content-defined multi-scale
  "hashblock"/"gapmer" scheme (reference: HashBlock.java, HashBlock_Database.java),
  built host-side into flat device-ready arrays;
- seed lookup is a vectorized gather over a packed hash table;
- candidate extension is a penalty-bounded banded DP (reference: PathAligner.java)
  executed for whole batches on the device — a CUDA kernel on NVIDIA GPUs,
  plain XLA elsewhere — over packed 4-bit bases;
- variant summarization (VCF / mutations / refs-map-count) accumulates per-position
  depth and allele counts with segment-sums.

Public API (mirrors reference Api.java):
    make_reference_index(...)  — build the index for one or more references
    align(query, index, params) — align a single query (synchronous path)
    AlignmentParameters         — the penalty model
"""

import os as _os

# the checkout's own compile-cache directory (listed in .gitignore)
_CHECKOUT_CACHE = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)


def compile_cache_dir() -> str:
    """The persistent compilation cache: JAX_COMPILATION_CACHE_DIR when it is
    set (JAX reads it itself), else the fixed directory inside the checkout.
    Tests and benchmarks use the same resolver."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _CHECKOUT_CACHE


def _configure_jax_cache() -> None:
    import jax

    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", _CHECKOUT_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_configure_jax_cache()

from mapper_tpu.align.params import AlignmentParameters
from mapper_tpu.api import Api, ReferenceIndex

__version__ = "0.1.0"

__all__ = [
    "AlignmentParameters",
    "Api",
    "ReferenceIndex",
    "__version__",
]

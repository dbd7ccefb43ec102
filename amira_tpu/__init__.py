"""amira-tpu: an accelerator-native AMR-gene detection engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
Danderson123/Amira (reference layout surveyed in SURVEY.md): per-read gene
calls are packed into integer tensors, the gene-space de Bruijn graph is
built with batched hash/sort/segment-sum ops on device, error correction and
multi-copy path clustering run as vectorized kernels, and the
minimap2/racon/jellyfish externals are replaced by native JAX alignment,
consensus and k-mer counting kernels.
"""

import os

import jax

# The gene-mer engine keys nodes/edges by 64-bit mix hashes; enable x64 so
# device-side sort/unique/segment ops can operate on them directly.
jax.config.update("jax_enable_x64", True)

# Persistent compile cache: JAX itself honours JAX_COMPILATION_CACHE_DIR;
# without it, compiles are cached at a fixed path inside the checkout, so
# pipeline re-runs and tests pay each compile once per shape.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jax.config.update(
        "jax_compilation_cache_dir", os.path.join(_checkout, ".jax_cache")
    )
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

__version__ = "0.1.0"

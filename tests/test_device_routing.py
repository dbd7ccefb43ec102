"""Device-path choices: native stable uint64 sorts in the graph tables, the
k-mer backend choice (decided without a device transfer), and a main path
that imports no pandas."""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np

from amira_tpu.ops import kmer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_uint64_argsort_is_numpy_stable_with_high_bits():
    rng = np.random.default_rng(5)
    pool = rng.integers(0, 2**64 - 1, size=64, dtype=np.uint64)
    pool[:3] = [0xFFFFFFFFFFFFFFFF, 0x8000000000000000, 0xFFFFFFFF00000000]
    keys = pool[rng.integers(0, len(pool), size=5000)]  # many ties
    got = np.asarray(jnp.argsort(jnp.asarray(keys), stable=True))
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))


def test_kmer_backend_choice_makes_no_probe(monkeypatch):
    """On an accelerator the dense counter is chosen from the table size
    and the input size alone: no device transfer is made to decide."""
    monkeypatch.setattr(
        jax, "devices", lambda *a: [SimpleNamespace(platform="gpu")]
    )

    def no_transfer(*a, **k):
        raise AssertionError("backend choice touched the device")

    monkeypatch.setattr(jax, "device_put", no_transfer)
    monkeypatch.delenv("AMIRA_TPU_KMER_BACKEND", raising=False)
    assert kmer._use_dense_device_count(kmer._DENSE_MIN_CODES, 15)
    assert not kmer._use_dense_device_count(kmer._DENSE_MIN_CODES - 1, 15)
    assert not kmer._use_dense_device_count(1 << 30, 16)  # table too big
    monkeypatch.setenv("AMIRA_TPU_KMER_BACKEND", "host")
    assert not kmer._use_dense_device_count(1 << 30, 15)
    monkeypatch.setenv("AMIRA_TPU_KMER_BACKEND", "device")
    assert kmer._use_dense_device_count(1000, 15)


def test_main_path_imports_without_pandas():
    code = (
        "import sys; sys.modules['pandas'] = None; "
        "import amira_tpu.pipeline, amira_tpu.promoters, amira_tpu.batch"
    )
    p = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120, env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert p.returncode == 0, p.stderr

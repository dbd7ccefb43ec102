"""chip_smoke.py's kernel-vs-reference checks and pipeline phase at small
widths on the CPU backend (the same functions it runs at real widths on the
GPU), and its refusal to run anywhere but on a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_windows_match_host_mirror():
    r = chip_smoke.check_windows(n_reads=300)
    assert r["windows"] > 0
    assert r["bucket_mismatches"] == 0
    assert r["flat_mismatches"] == 0


def test_graph_tables_match_lexsort():
    r = chip_smoke.check_graph_tables(n_occ=1 << 12, n_reads=300)
    assert r["node_mismatches"] == 0
    assert r["edge_mismatches"] == 0


def test_sw_matches_cpu_and_host_traceback():
    r = chip_smoke.check_sw(B=16, Lq=256, W=64, host_slice=16)
    assert r["mapped_lanes"] >= 8
    assert r["mismatches"] == 0
    assert r["host_traceback_mismatches"] == 0


def test_dense_kmer_matches_host_counter(monkeypatch):
    from amira_tpu.ops import kmer

    monkeypatch.setattr(kmer, "_DENSE_CHUNK", 1 << 16)
    r = chip_smoke.check_dense_kmer(n_codes=1 << 15, k=9, n_queries=3)
    assert r["distinct_kmers"] > 0
    assert r["bin_mismatches"] == 0
    assert r["histo_mismatches"] == 0
    assert r["median_mismatches"] == 0


def test_pipeline_phase_calls_true_alleles(tmp_path):
    r = chip_smoke.pipeline_phase(str(tmp_path), 300, n_genes=40)
    assert sorted(r["identity"]) == ["amrX_1", "amrX_2", "amrY_1"]
    assert all(v == 1.0 for v in r["identity"].values())
    assert {"initial_graph_build", "allele_polishing"} <= {
        p["phase"] for p in r["phases"]
    }


def _run(cmd, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


def test_refuses_to_run_without_gpu():
    p = _run([sys.executable, "chip_smoke.py"], REPO)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "pipeline" not in p.stdout


def test_fails_alone_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run([sys.executable, "chip_smoke.py"], str(tmp_path))
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_dir(tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits at
    a fixed path inside the checkout."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if from_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    p = subprocess.run(
        [
            sys.executable, "-c",
            "import amira_tpu, jax; print(jax.config.jax_compilation_cache_dir)",
        ],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert p.returncode == 0, p.stderr
    want = str(tmp_path / "cc") if from_env else os.path.join(REPO, ".jax_cache")
    assert p.stdout.strip() == want

"""Every device kernel of the main path at real widths on the GPU, against
its plain reference (exact: all integer arithmetic). These skip without a
card; `python chip_smoke.py` runs them on one."""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


def test_gpu_takes_the_accelerator_routes():
    from amira_tpu.ops import align, kmer

    assert align._use_device_traceback()
    assert not align._use_fine_buckets()
    assert kmer._use_dense_device_count(kmer._DENSE_CHUNK, 15)


def test_windows_at_a_million_genes():
    r = chip_smoke.check_windows()
    assert r["genes"] >= 1_000_000
    assert r["bucket_mismatches"] == 0
    assert r["flat_mismatches"] == 0


def test_graph_tables_at_two_million_occurrences():
    r = chip_smoke.check_graph_tables()
    assert r["node_mismatches"] == 0
    assert r["edge_mismatches"] == 0


def test_sw_at_512_2048_256():
    r = chip_smoke.check_sw()
    assert r["mapped_lanes"] >= 256
    assert r["mismatches"] == 0
    assert r["host_traceback_mismatches"] == 0


def test_dense_kmer_on_one_full_chunk():
    r = chip_smoke.check_dense_kmer()
    assert r["codes"] > (1 << 26) - 5001
    assert r["bin_mismatches"] == 0
    assert r["histo_mismatches"] == 0
    assert r["median_mismatches"] == 0

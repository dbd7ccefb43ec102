"""Results-layer parity against THE UPSTREAM implementation RUN in-process
(via tests/ref_shims): clustering output (process_reads), cluster
supplementation + fastq writing (write_fastqs_for_genes) and final row
filtering (filter_results) produce the same structures/rows on real
fixtures — extending the upstream-run cross-reference harness through the
results layer (result_utils.py:58-81,124-207,1191-1232,1243-1257).

The polishing stage itself (get_alleles) shells out to minimap2/racon
upstream and cannot run here; its device equivalents are pinned by golden
tests (test_consensus_golden.py, test_polish_batched.py). Everything
upstream of it and downstream of it IS the upstream code, run for real.
"""

import copy
import gzip
import json
import os
import re
import sys

import numpy as np
import pandas as pd
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from ref_shims import install_reference_shims  # noqa: E402

REF = "/root/reference/tests"

FIXTURES = [
    ("three", ["mphANG_0479861"]),
    ("five", ["dfrA17NG_0481541"]),
]


def _load(name):
    with open(f"{REF}/{name}") as fh:
        return json.load(fh)


def _fixture_inputs(name):
    calls = _load(f"complex_gene_calls_{name}.json")
    positions = _load(f"complex_gene_positions_{name}.json")
    positions = {r: [tuple(p) for p in positions[r]] for r in positions}
    # deterministic read sequences long enough to cover every gene span
    rng = np.random.RandomState(41)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    master = lut[rng.randint(0, 4, size=2_000_000)].tobytes().decode()
    fastq = {}
    for i, (r, pos) in enumerate(sorted(positions.items())):
        span = (pos[-1][1] + 1) if pos else 1
        off = (i * 9973) % max(1, len(master) - span - 1)
        seq = master[off : off + span]
        fastq[r] = {"sequence": seq, "quality": "I" * len(seq)}
    return calls, positions, fastq


def _norm_gene(tok, genes):
    for g in genes:
        m = re.match(rf"^([+-]){re.escape(g)}_\d+$", tok)
        if m:
            return m.group(1) + g
    return tok


def _norm_allele(allele, genes):
    """gene_N allele names carry hash-order numbering; strip the suffix."""
    for g in genes:
        if re.match(rf"^{re.escape(g)}_\d+$", allele):
            return g
    return allele


def _cluster_shape(clusters_of_interest, genes):
    """component -> gene -> multiset of member-read groups, allele
    numbering normalized away."""
    out = {}
    for comp, by_gene in clusters_of_interest.items():
        for gene, by_allele in by_gene.items():
            groups = sorted(
                tuple(sorted(reads)) for reads in by_allele.values()
            )
            out.setdefault(comp, {})[_norm_allele(gene, genes)] = groups
    return out


def _supplemented_shape(supplemented, genes):
    return sorted(
        (
            _norm_allele(a, genes),
            tuple(sorted(reads)),
        )
        for a, reads in supplemented.items()
    )


def _run_side(graph_cls, process_reads, write_fastqs, calls, positions,
              fastq, genes, tmpdir):
    graph = graph_cls(dict(calls), 3, copy.deepcopy(positions))
    short_reads = graph.get_short_read_annotations()
    srgp = graph.get_short_read_gene_positions()
    omnc = float(
        np.mean([n.get_node_coverage() for n in graph.all_nodes()])
    )
    clusters_to_add, clusters_of_interest, path_reads = process_reads(
        graph, genes, 1, short_reads, srgp, omnc
    )
    (longest, supplemented, comp_map, files) = write_fastqs(
        clusters_of_interest, omnc, fastq, tmpdir
    )
    return clusters_of_interest, clusters_to_add, longest, supplemented, files


@pytest.mark.parametrize("name,genes", FIXTURES)
def test_results_layer_matches_upstream(name, genes, tmp_path):
    """process_reads + write_fastqs_for_genes parity: identical cluster
    structure, supplemented membership, longest-read selections and
    on-disk fastq contents (allele numbering normalized)."""
    RefGraph = install_reference_shims()
    from amira.result_utils import process_reads as ref_process_reads
    from amira.result_utils import (
        write_fastqs_for_genes as ref_write_fastqs,
    )

    from amira_tpu.graph import GeneMerGraph
    from amira_tpu.results import process_reads, write_fastqs_for_genes

    calls, positions, fastq = _fixture_inputs(name)
    ref_dir = str(tmp_path / "ref")
    our_dir = str(tmp_path / "ours")
    os.makedirs(os.path.join(ref_dir, "AMR_allele_fastqs"), exist_ok=True)
    os.makedirs(os.path.join(our_dir, "AMR_allele_fastqs"), exist_ok=True)

    r_coi, r_add, r_longest, r_supp, r_files = _run_side(
        RefGraph, ref_process_reads, ref_write_fastqs, calls, positions,
        fastq, genes, ref_dir,
    )
    o_coi, o_add, o_longest, o_supp, o_files = _run_side(
        GeneMerGraph, process_reads, write_fastqs_for_genes, calls,
        positions, fastq, genes, our_dir,
    )

    assert _cluster_shape(o_coi, genes) == _cluster_shape(r_coi, genes)
    assert o_add == r_add
    assert _supplemented_shape(o_supp, genes) == _supplemented_shape(
        r_supp, genes
    )
    # longest-read fasta entries: same sequence set once names normalize
    norm = lambda entries: sorted(  # noqa: E731
        (_norm_allele(e.split("\n")[0][1:], genes), e.split("\n")[1])
        for e in entries
    )
    assert norm(o_longest) == norm(r_longest)
    # the written per-allele fastqs hold identical read sets + sequences
    def fq_contents(paths):
        out = []
        for p in sorted(paths):
            with gzip.open(p, "rt") as fh:
                lines = fh.read().splitlines()
            recs = sorted(
                (lines[i], lines[i + 1]) for i in range(0, len(lines), 4)
            )
            out.append(
                (_norm_allele(os.path.basename(os.path.dirname(p)), genes),
                 recs)
            )
        return sorted(out)

    assert fq_contents(o_files) == fq_contents(r_files)


def test_filter_results_rows_match_upstream(tmp_path):
    """filter_results row-for-row parity on a frame exercising every
    branch: identity/coverage/depth deletions, the partial-presence flag,
    and the all-AMR-reads contaminant flag."""
    install_reference_shims()
    from amira.result_utils import filter_results as ref_filter_results

    from amira_tpu.results import filter_results

    genes = {"mphA", "dfrA17"}
    rows = []
    cases = [
        # allele, identity, coverage, rel_depth -> expected outcome
        ("mphA_1", 99.0, 100.0, 1.0),      # kept, clean
        ("mphA_2", 80.0, 100.0, 1.0),      # deleted: identity
        ("dfrA17_1", 99.0, 50.0, 1.0),     # deleted: coverage
        ("dfrA17_2", "95.0/88.0", "92.0/70.0", 1.0),  # kept, split values
        ("dfrA17_3", 99.0, 85.0, 1.0),     # kept, partial-presence flag
        ("mphA_3", 99.0, 100.0, 0.01),     # deleted: relative depth
        ("mphA_4", 99.0, 100.0, 1.0),      # kept, contaminant flag
    ]
    for allele, ident, cov, depth in cases:
        rows.append({
            "Determinant name": allele.split("_")[0],
            "Sequence name": "x",
            "Closest reference": "ref",
            "Reference length": 100,
            "Identity (%)": ident,
            "Coverage (%)": cov,
            "Amira allele": allele,
            "Number of reads used for polishing": 5,
            "Relative mean read depth": depth,
            "Approximate cellular copy number": depth,
        })
    supplemented = {
        a: [f"r{a}_0_99"] for a, *_ in cases
    }
    annotated = {
        f"r{a}": ["+mphA", "+coreGene"] for a, *_ in cases
    }
    # the contaminant case: every read contains ONLY genes of interest
    annotated["rmphA_4"] = ["+mphA", "-dfrA17"]
    # required_coverage 0.8 < the hard partial-presence threshold (90%), so
    # the 85%-coverage allele is kept AND flagged
    args = (
        0.2, supplemented, annotated, genes, 0.9, 0.8, 30.0, set(), False,
    )
    ours = pd.DataFrame(
        filter_results(copy.deepcopy(rows), *[copy.deepcopy(a) for a in args])
    )
    theirs = ref_filter_results(
        pd.DataFrame(rows), *[copy.deepcopy(a) for a in args]
    )
    pd.testing.assert_frame_equal(
        ours.reset_index(drop=True), theirs.reset_index(drop=True)
    )
    assert list(ours["Amira allele"]) == [
        "mphA_1", "dfrA17_2", "dfrA17_3", "mphA_4"
    ]
    assert list(ours["Comments"]) == [
        "", "", "Partially present gene.", "Potential contaminant.",
    ]


def _amr_genes(calls, min_count):
    counts: dict = {}
    for genes in calls.values():
        for g in set(genes):
            counts[g[1:]] = counts.get(g[1:], 0) + 1
    return sorted(
        g for g, c in counts.items() if c >= min_count and "NG_" in g
    )


def _fixture_inputs_files(calls_file, pos_file):
    calls = _load(calls_file)
    positions = _load(pos_file)
    positions = {r: [tuple(p) for p in positions[r]] for r in positions}
    rng = np.random.RandomState(41)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    master = lut[rng.randint(0, 4, size=2_000_000)].tobytes().decode()
    fastq = {}
    for i, (r, pos) in enumerate(sorted(positions.items())):
        span = (pos[-1][1] + 1) if pos else 1
        off = (i * 9973) % max(1, len(master) - span - 1)
        seq = master[off : off + span]
        fastq[r] = {"sequence": seq, "quality": "I" * len(seq)}
    return calls, positions, fastq


def test_results_layer_junction_fixture_exact_parity(tmp_path):
    """The 47-read junction fixture (reads seen in both orientations —
    where the documented clustering divergences live): the results layer
    is EXACTLY parity with the upstream run — same supplemented alleles,
    same member spans, same longest-read picks."""
    RefGraph = install_reference_shims()
    from amira.result_utils import process_reads as ref_process_reads
    from amira.result_utils import (
        write_fastqs_for_genes as ref_write_fastqs,
    )

    from amira_tpu.graph import GeneMerGraph
    from amira_tpu.results import process_reads, write_fastqs_for_genes

    calls, positions, fastq = _fixture_inputs_files(
        "test_path_calls.json", "test_path_positions.json"
    )
    genes = _amr_genes(calls, 2)
    assert genes  # blaCMY54NG_0488491
    ref_dir = str(tmp_path / "ref")
    our_dir = str(tmp_path / "ours")
    os.makedirs(os.path.join(ref_dir, "AMR_allele_fastqs"), exist_ok=True)
    os.makedirs(os.path.join(our_dir, "AMR_allele_fastqs"), exist_ok=True)
    r_coi, r_add, _rl, r_supp, _rf = _run_side(
        RefGraph, ref_process_reads, ref_write_fastqs, calls, positions,
        fastq, genes, ref_dir,
    )
    o_coi, o_add, _ol, o_supp, _of = _run_side(
        GeneMerGraph, process_reads, write_fastqs_for_genes, calls,
        positions, fastq, genes, our_dir,
    )
    assert _cluster_shape(o_coi, genes) == _cluster_shape(r_coi, genes)
    assert o_add == r_add
    assert _supplemented_shape(o_supp, genes) == _supplemented_shape(
        r_supp, genes
    )


def test_results_layer_fixture_nine_divergence_bounded(tmp_path):
    """Fixture nine (4,832 reads, 5 AMR genes) carries the documented
    reverse-orientation context divergence (COMPONENTS.md §2.8). Bound
    what it can change at the RESULTS layer, upstream run vs repo:
    identical allele COUNT per run, >= 85% of supplemented member-groups
    byte-identical, and the span divergence one-sided in the repo's favor
    (repo may assign MORE read spans; it may lose only a small tail).
    Measured on this fixture: 32 vs 32 alleles, 28 identical groups,
    11/542 spans lost, 108 gained."""
    RefGraph = install_reference_shims()
    from amira.result_utils import process_reads as ref_process_reads
    from amira.result_utils import (
        write_fastqs_for_genes as ref_write_fastqs,
    )

    from amira_tpu.graph import GeneMerGraph
    from amira_tpu.results import process_reads, write_fastqs_for_genes

    calls, positions, fastq = _fixture_inputs_files(
        "complex_gene_calls_nine.json", "complex_gene_positions_nine.json"
    )
    genes = _amr_genes(calls, 3)
    assert len(genes) >= 5
    ref_dir = str(tmp_path / "ref")
    our_dir = str(tmp_path / "ours")
    os.makedirs(os.path.join(ref_dir, "AMR_allele_fastqs"), exist_ok=True)
    os.makedirs(os.path.join(our_dir, "AMR_allele_fastqs"), exist_ok=True)
    _rc, r_add, _rl, r_supp, _rf = _run_side(
        RefGraph, ref_process_reads, ref_write_fastqs, calls, positions,
        fastq, genes, ref_dir,
    )
    _oc, o_add, _ol, o_supp, _of = _run_side(
        GeneMerGraph, process_reads, write_fastqs_for_genes, calls,
        positions, fastq, genes, our_dir,
    )
    assert o_add == r_add
    rs = set(_supplemented_shape(r_supp, genes))
    os_ = set(_supplemented_shape(o_supp, genes))
    assert len(rs) == len(os_)  # same number of recovered alleles
    assert len(rs & os_) >= int(0.85 * len(rs))
    r_spans = {m for _g, ms in rs for m in ms}
    o_spans = {m for _g, ms in os_ for m in ms}
    lost = len(r_spans - o_spans)
    assert lost <= max(3, int(0.04 * len(r_spans))), (
        f"repo lost {lost} of {len(r_spans)} upstream spans"
    )

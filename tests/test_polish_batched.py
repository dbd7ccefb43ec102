"""Batched lockstep polishing (results.get_alleles) == the serial
per-allele pipeline (results.compare_reads_to_references), row for row.

The batched path shares kernel launches across alleles and reuses band
placements across polish iterations (no per-iteration re-seeding); both
must produce identical result rows (result_utils.py:728-765 contract)."""

import json
import os
import shutil
import tempfile

import numpy as np
import pytest

from amira_tpu.results import compare_reads_to_references, get_alleles

N_CLUSTERS = 6
N_READS = 10


def _workload(tmpdir, seed=11):
    rng = np.random.RandomState(seed)
    bases = np.array(list("ACGT"))

    def rand_seq(n):
        return "".join(rng.choice(bases, size=n))

    def mutate(seq, rate):
        out = []
        for ch in seq:
            r = rng.rand()
            if r < rate:
                out.append(str(rng.choice([c for c in "ACGT" if c != ch])))
            elif r < 1.5 * rate:
                continue
            else:
                out.append(ch)
        return "".join(out)

    reference_genes, clusters, fastq, phenos = {}, {}, {}, {}
    for gi in range(N_CLUSTERS):
        gene = f"gene{gi}"
        true_allele = rand_seq(700)
        reference_genes[gene] = {
            f"{gene}.a1": true_allele,
            f"{gene}.a2": mutate(true_allele, 0.02),
        }
        phenos[f"{gene}.a1"] = f"pheno {gene} a1"
        phenos[f"{gene}.a2"] = f"pheno {gene} a2"
        members = []
        for ri in range(N_READS):
            rid = f"r{gi}_{ri}"
            flank_l, flank_r = rand_seq(120), rand_seq(120)
            read_seq = flank_l + mutate(true_allele, 0.03) + flank_r
            fastq[rid] = {"sequence": read_seq, "quality": "I" * len(read_seq)}
            members.append(f"{rid}_{120}_{len(read_seq) - 121}")
        clusters[f"{gene}_1"] = members
    pheno_path = os.path.join(tmpdir, "calls.json")
    with open(pheno_path, "w") as fh:
        json.dump(phenos, fh)
    return clusters, reference_genes, fastq, pheno_path, phenos


def test_batched_equals_serial_rows():
    tmpdir = tempfile.mkdtemp(prefix="amira_polish_eq_")
    try:
        clusters, refs, fastq, pheno_path, phenos = _workload(tmpdir)
        out_b = os.path.join(tmpdir, "batched")
        os.makedirs(out_b, exist_ok=True)
        rows = get_alleles(clusters, out_b, refs, pheno_path, fastq, 0.9, 0.9)
        batched_rows = {row["Amira allele"]: row for row in rows}
        out_s = os.path.join(tmpdir, "serial")
        os.makedirs(out_s, exist_ok=True)
        for allele_name, members in clusters.items():
            row = compare_reads_to_references(
                allele_name, members, out_s, refs, fastq, phenos, 0.9, 0.9
            )
            b = batched_rows[allele_name]
            for key, val in row.items():
                assert b.get(key) == val, (
                    allele_name, key, b.get(key), val
                )
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def test_batched_polished_sequences_match_serial():
    """The 04.polished_sequence.fasta artifacts must byte-match too."""
    tmpdir = tempfile.mkdtemp(prefix="amira_polish_eq2_")
    try:
        clusters, refs, fastq, pheno_path, phenos = _workload(tmpdir, seed=23)
        out_b = os.path.join(tmpdir, "batched")
        os.makedirs(out_b, exist_ok=True)
        get_alleles(clusters, out_b, refs, pheno_path, fastq, 0.9, 0.9)
        out_s = os.path.join(tmpdir, "serial")
        os.makedirs(out_s, exist_ok=True)
        for allele_name, members in clusters.items():
            compare_reads_to_references(
                allele_name, members, out_s, refs, fastq, phenos, 0.9, 0.9
            )
            pb = os.path.join(out_b, "AMR_allele_fastqs", allele_name,
                              "04.polished_sequence.fasta")
            ps = os.path.join(out_s, allele_name, "04.polished_sequence.fasta")
            if os.path.exists(ps):
                assert os.path.exists(pb), allele_name
                assert open(pb).read() == open(ps).read(), allele_name
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

"""Allele-recovery accuracy under ONT-profile noise (BASELINE config axes).

Runs the full pipeline on a synthetic isolate with known truth (amrX at two
genomic loci + amrY, configurable sub/indel read error), then measures:

  - recovered-allele nucleotide identity vs the TRUTH sequence (independent
    banded edit-distance here, not the pipeline's own aligner) — the
    reference paper's headline axis (99.9%, upstream README.md:172;
    racon semantics it replaces: result_utils.py:285-335,1089-1159)
  - copy-number recall/precision: detected AMR rows vs the genomic truth
    (amrX x2 + amrY x1), the paper's 98.4%/97.9% axes

Usage: python accuracy_run.py [--reads 20000] [--sub 0.02] [--indel 0.01]
       [--workdir DIR]
(JAX_PLATFORMS=cpu runs it on the CPU backend.)
Prints a markdown accuracy table (for SCALE_REPORT.md) and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def edit_distance(a: str, b: str) -> int:
    """Plain O(nm) Levenshtein with numpy rows (alleles are ~hundreds of
    bases; exactness beats the banded version's complexity here)."""
    av = np.frombuffer(a.encode(), np.uint8)
    bv = np.frombuffer(b.encode(), np.uint8)
    n, m = len(av), len(bv)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = np.arange(m + 1, dtype=np.int32)
    for i in range(1, n + 1):
        cost = (av[i - 1] != bv).astype(np.int32)
        cur = np.empty(m + 1, np.int32)
        cur[0] = i
        # substitution/deletion are vectorizable; insertion is a prefix
        # min-scan: cur[j] = min(base[j], min_{t<j}(cur[t] + j - t))
        base = np.minimum(prev[1:] + 1, prev[:-1] + cost)
        cur[1:] = base
        run = np.minimum.accumulate(cur - np.arange(m + 1))
        cur = np.minimum(cur, run + np.arange(m + 1))
        prev = cur
    return int(prev[m])


def identity(a: str, b: str) -> float:
    if a == b:
        return 1.0
    if not a or not b:
        return 0.0
    return max(0.0, 1.0 - edit_distance(a, b) / max(len(a), len(b)))


def recovered_allele_seq(out: str, allele: str) -> str | None:
    """The pipeline's recovered nucleotide sequence of one Amira allele:
    the polished FASTA, else the unpolished draft, else None."""
    for name in ("06.final_sequence.fasta", "03.sequence_to_polish.fasta"):
        path = os.path.join(out, "AMR_allele_fastqs", allele, name)
        if os.path.exists(path):
            with open(path) as fh:
                return "".join(fh.read().split("\n")[1:]).strip()
    return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=20000)
    ap.add_argument("--sub", type=float, default=0.02)
    ap.add_argument("--indel", type=float, default=0.01)
    ap.add_argument("--workdir", default="/tmp/amira_accuracy")
    args = ap.parse_args()

    sys.path.insert(
        0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    )
    from synthetic import make_isolate, scale_layout

    # the scale harness's genome shape; 20k reads give ~75x per-gene depth,
    # a realistic ONT isolate
    layout = scale_layout()

    os.makedirs(args.workdir, exist_ok=True)
    files = make_isolate(
        args.workdir,
        seed=23,
        n_reads=args.reads,
        layout=layout,
        amr_genes=("amrX", "amrY"),
        genes_per_read=(10, 20),
        gene_len=400,
        sub=args.sub,
        indel=args.indel,
        fast=True,
        call_noise=0.05,
    )
    with open(files["truth"]) as fh:
        truth = json.load(fh)

    from amira_tpu.__main__ import main as amira_main

    out = os.path.join(args.workdir, "out")
    t0 = time.time()
    try:
        amira_main([
            "--pandoraJSON", files["calls"],
            "--gene-positions", files["positions"],
            "--reads", files["fastq"],
            "--species", "Escherichia_coli",
            "--amr-fasta", files["amr_fasta"],
            "--amr-calls", files["amr_calls"],
            "--core-genes", files["core_genes"],
            "--plasmid-genes", files["plasmid_genes"],
            "--output", out, "--quiet",
        ])
    except SystemExit as e:
        if e.code not in (None, 0):
            raise
    wall = time.time() - t0

    import csv

    with open(os.path.join(out, "amira_results.tsv"), newline="") as fh:
        result_rows = list(csv.DictReader(fh, delimiter="\t"))

    # --- recovered-allele identity vs truth
    rows = []
    identities = []
    for row in result_rows:
        gene = row["Determinant name"]
        allele = row["Amira allele"]
        seq = recovered_allele_seq(out, allele)
        true_seq = truth["allele_seqs"].get(gene)
        ident = identity(seq or "", true_seq or "")
        identities.append(ident)
        rows.append((allele, gene, len(seq or ""), len(true_seq or ""),
                     100.0 * ident))

    # --- copy-number recall / precision (rows vs genomic truth)
    detected: dict = {}
    for row in result_rows:
        gene = row["Determinant name"]
        detected[gene] = detected.get(gene, 0) + 1
    tp = sum(
        min(detected.get(g, 0), c) for g, c in truth["copy_counts"].items()
    )
    fn = sum(
        max(c - detected.get(g, 0), 0)
        for g, c in truth["copy_counts"].items()
    )
    fp = sum(
        max(detected.get(g, 0) - truth["copy_counts"].get(g, 0), 0)
        for g in detected
    )
    recall = tp / max(tp + fn, 1)
    precision = tp / max(tp + fp, 1)
    mean_ident = float(np.mean(identities)) if identities else 0.0

    import jax

    platform = jax.devices()[0].platform
    print(f"\n## Allele-recovery accuracy ({args.reads:,} reads, "
          f"{100 * args.sub:.0f}%/{100 * args.indel:.0f}% sub/indel, "
          f"{platform}, {wall:.0f}s)\n")
    print("| Amira allele | gene | recovered len | truth len | "
          "identity vs truth |")
    print("|---|---|---|---|---|")
    for allele, gene, ls, lt, ident in rows:
        print(f"| {allele} | {gene} | {ls} | {lt} | {ident:.2f}% |")
    print(f"\nMean recovered-allele identity: **{100 * mean_ident:.2f}%** · "
          f"copy recall **{100 * recall:.1f}%** ({tp}/{tp + fn}) · "
          f"copy precision **{100 * precision:.1f}%** ({tp}/{tp + fp})")
    print(json.dumps({
        "metric": "allele_recovery_identity_pct",
        "value": round(100 * mean_ident, 2),
        "unit": "%",
        "copy_recall": round(recall, 4),
        "copy_precision": round(precision, 4),
        "reads": args.reads,
        "sub": args.sub,
        "indel": args.indel,
        "platform": platform,
    }))


if __name__ == "__main__":
    main()

"""500k-read ceiling run (BASELINE config scale).

Generates a synthetic isolate at the reference's subsample ceiling
(upstream amira/__main__.py:136-142: 500,000 reads), with pandora-
style gene-call noise so the cleaning loop and clustering see realistic
pre-convergence diversity, runs the FULL pipeline (ingest -> TSV), and
writes a per-phase wall-clock report (<workdir>/out/SCALE_REPORT.md by
default) from the pipeline's own phase_timings.json. It runs on whatever
device JAX picks; `python chip_smoke.py --reads 500000` is the GPU run
with every kernel checked.

Usage: python scale_run.py [--reads 500000] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=500_000)
    ap.add_argument("--workdir", default="/tmp/amira_scale")
    ap.add_argument("--report", default=None)
    ap.add_argument(
        "--reuse", action="store_true",
        help="skip generation when the workdir already holds the isolate "
        "(generated earlier with the same --reads/--workdir)",
    )
    ap.add_argument(
        "--generate-only", action="store_true",
        help="generate the isolate and exit (pre-generation in background)",
    )
    args = ap.parse_args()

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from synthetic import make_isolate, scale_isolate_kwargs

    os.makedirs(args.workdir, exist_ok=True)
    t0 = time.time()
    # single source of truth: these kwargs feed BOTH make_isolate and the
    # --reuse marker hash, so editing the generation call can never leave a
    # stale workdir silently reused
    gen_kwargs = scale_isolate_kwargs()
    layout = gen_kwargs["layout"]
    gen_params = tuple(sorted(
        (k, repr(v)) for k, v in gen_kwargs.items()
    ))
    import hashlib

    param_tag = hashlib.sha1(repr(gen_params).encode()).hexdigest()[:10]
    marker = os.path.join(
        args.workdir, f".generated_{args.reads}_{param_tag}"
    )
    if args.reuse and os.path.exists(marker):
        files = {
            name: os.path.join(args.workdir, fn)
            for name, fn in (
                ("calls", "calls.json"),
                ("positions", "positions.json"),
                ("fastq", "reads.fastq.gz"),
                ("amr_fasta", "AMR_alleles_unified.fa"),
                ("amr_calls", "AMR_calls.json"),
                ("core_genes", "core_genes.txt"),
                ("plasmid_genes", "plasmid_genes.txt"),
            )
        }
        gen_s = 0.0
        sys.stderr.write("[scale] reusing generated isolate\n")
    else:
        sys.stderr.write(f"[scale] generating {args.reads} reads...\n")
        files = make_isolate(
            args.workdir, n_reads=args.reads, **gen_kwargs
        )
        with open(marker, "w") as fh:
            fh.write("ok\n")
        gen_s = time.time() - t0
        sys.stderr.write(f"[scale] generated in {gen_s:.0f}s\n")
    if args.generate_only:
        sys.stderr.write("[scale] generate-only: done\n")
        return

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
            "--output", out,
        ])
    except SystemExit as e:
        if e.code not in (None, 0):
            raise
    total_s = time.time() - t0

    with open(os.path.join(out, "phase_timings.json")) as fh:
        phases = json.load(fh)
    with open(os.path.join(out, "amira_results.tsv")) as fh:
        n_rows = sum(1 for _ in fh) - 1

    import jax

    platform = jax.devices()[0].platform
    rows = []
    phase_total = sum(p["seconds"] for p in phases)
    for p in phases:
        pct = 100.0 * p["seconds"] / max(phase_total, 1e-9)
        extra = f" ({p['items_per_sec']:.0f} {p.get('unit','items')}/s)" if "items_per_sec" in p else ""
        rows.append(
            f"| {p['phase']} | {p['seconds']:.1f} | {pct:.1f}% |{extra} |"
        )
    clustering_s = sum(
        p["seconds"] for p in phases if "clustering" in p["phase"]
    )
    # default into the workdir: the repo-root SCALE_REPORT.md is a curated
    # multi-round document, updated by hand from these per-run reports
    report = args.report or os.path.join(out, "SCALE_REPORT.md")
    with open(report, "w") as fh:
        fh.write(
            f"""# 500k-read ceiling run

Synthetic isolate at the reference's subsample ceiling
(upstream `amira/__main__.py:136-142`): **{args.reads:,} reads**,
{len(layout):,}-slot genome (E. coli-like gene count), amrX at two genomic
loci + amrY, 10-20 genes/read,
5% pandora-style call noise (drops/strand flips), 2%/1% sub/indel
sequence error. Generated in {gen_s:.0f}s (vectorized simulator,
tests/synthetic.py:mutate_fast).

Platform: **{platform}** · end-to-end wall-clock **{total_s:.0f}s**
({args.reads/total_s:.0f} reads/s ingest->TSV) · AMR rows: {n_rows}
(expected amrX x2 + amrY).

| phase | seconds | % of phase total | throughput |
|---|---|---|---|
{os.linesep.join(rows)}

Clustering share: {100.0 * clustering_s / max(phase_total, 1e-9):.1f}%
of phase time.
"""
        )
    sys.stderr.write(
        f"[scale] done: {total_s:.0f}s e2e, {n_rows} AMR rows, "
        f"report -> {report}\n"
    )
    if n_rows < 2:
        raise SystemExit("expected the multi-copy AMR calls")


if __name__ == "__main__":
    main()

"""Synthetic isolate generator for end-to-end pipeline tests.

Builds a gene-space genome with nucleotide sequences, simulates noisy ONT
reads annotated with per-read gene calls + positions (the pandora JSON
contract), and writes the species asset files (allele FASTA, phenotype JSON,
core/plasmid gene lists)."""

from __future__ import annotations

import gzip
import json
import os

import numpy as np


def random_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def mutate(rng, seq, sub=0.03, indel=0.02):
    out = []
    for ch in seq:
        r = rng.rand()
        if r < sub:
            out.append(rng.choice([c for c in "ACGT" if c != ch]))
        elif r < sub + indel / 2:
            continue
        elif r < sub + indel:
            out.append(ch)
            out.append(rng.choice(list("ACGT")))
        else:
            out.append(ch)
    return "".join(out)


def revcomp(seq):
    return seq.translate(str.maketrans("ACGT", "TGCA"))[::-1]


_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)
_CODE = np.full(256, 0, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i


def mutate_fast(rng, codes, sub=0.03, indel=0.02):
    """Vectorized twin of mutate() over uint8 base codes (different RNG
    stream, same error model) — needed for 100k-500k-read isolates where
    the per-character loop would dominate generation time."""
    n = len(codes)
    r = rng.rand(n)
    subs = r < sub
    dels = (r >= sub) & (r < sub + indel / 2)
    ins = (r >= sub + indel / 2) & (r < sub + indel)
    out = codes.copy()
    if subs.any():
        out[subs] = (codes[subs] + rng.randint(1, 4, size=int(subs.sum()))) % 4
    lens = np.where(dels, 0, 1) + ins
    starts = np.cumsum(lens) - lens
    res = np.empty(int(lens.sum()), dtype=np.uint8)
    keep = ~dels
    res[starts[keep]] = out[keep]
    if ins.any():
        res[starts[ins] + 1] = rng.randint(0, 4, size=int(ins.sum())).astype(
            np.uint8
        )
    return res


def scale_layout(n_genes=4000):
    """The scale isolate's genome: n_genes single-copy genes, amrX at two
    loci (multi-copy separation work) and amrY at one. At the default 4,000
    genes (an E. coli-like gene count; 4,003 slots) 500k reads give
    ~1900x per-gene depth, the order of the reference's subsample ceiling."""
    x_loci = (n_genes * 500 // 4000, n_genes * 2900 // 4000)
    y_locus = n_genes * 1700 // 4000
    layout = []
    for i in range(n_genes):
        layout.append(f"gene{i}")
        if i in x_loci:
            layout.append("amrX")
        if i == y_locus:
            layout.append("amrY")
    return layout


def scale_isolate_kwargs(n_genes=4000, seed=17):
    """make_isolate arguments of the scale isolate (scale_run.py,
    chip_smoke.py): reads span 10-20 genes of 400 bp, 5% pandora-style call
    noise, 2%/1% sub/indel read error."""
    return dict(
        seed=seed,
        layout=scale_layout(n_genes),
        amr_genes=("amrX", "amrY"),
        genes_per_read=(10, 20),
        gene_len=400,
        fast=True,
        call_noise=0.05,
    )


def make_isolate(
    tmpdir,
    seed=0,
    n_reads=60,
    genes_per_read=(3, 6),
    gene_len=500,
    amr_genes=("amrX",),
    layout=None,
    sub=0.02,
    indel=0.01,
    reverse_fraction=0.3,
    fast=False,
    call_noise=0.0,
):
    """Returns dict of file paths: calls, positions, fastq, amr_fasta,
    amr_calls, core_genes, plasmid_genes, plus ground truth.

    fast=True switches read-error simulation to the vectorized mutate_fast
    (different RNG stream than the default loop, so goldens pinned to
    fast=False seeds are unaffected); required for >=100k-read isolates.

    call_noise > 0 simulates pandora miscalls: per gene call, with that
    probability the call is dropped or strand-flipped (never on AMR genes),
    so the graph-cleaning loop sees realistic pre-convergence diversity
    instead of error-free calls that dedup to a handful of sequences."""
    rng = np.random.RandomState(seed)
    if layout is None:
        layout = ["geneA", "geneB", "geneC", "amrX", "geneD", "geneE", "geneF", "geneG"]
    gene_seqs = {
        g: random_seq(rng, gene_len) for g in set(layout) | set(amr_genes)
    }
    gene_codes = {g: _CODE[np.frombuffer(s.encode(), np.uint8)] for g, s in gene_seqs.items()}
    n_genes = len(layout)
    lo, hi = genes_per_read
    calls, positions, fastq = {}, {}, {}
    for i in range(n_reads):
        span = min(rng.randint(lo, hi + 1), n_genes)
        start = rng.randint(0, n_genes - span + 1)
        sub_layout = layout[start : start + span]
        if fast:
            noisy_parts = [
                _LUT[mutate_fast(rng, gene_codes[g], sub, indel)]
                .tobytes()
                .decode()
                for g in sub_layout
            ]
        else:
            noisy_parts = [mutate(rng, gene_seqs[g], sub, indel) for g in sub_layout]
        read_genes = [f"+{g}" for g in sub_layout]
        pos = []
        cursor = 0
        for p in noisy_parts:
            pos.append((cursor, cursor + len(p) - 1))
            cursor += len(p)
        seq = "".join(noisy_parts)
        if rng.rand() < reverse_fraction:
            seq = revcomp(seq)
            L = len(seq)
            read_genes = [
                ("-" if g[0] == "+" else "+") + g[1:] for g in reversed(read_genes)
            ]
            pos = [(L - 1 - e, L - 1 - s) for (s, e) in reversed(pos)]
        if call_noise > 0:
            kept_genes, kept_pos = [], []
            for g, p in zip(read_genes, pos):
                r = rng.rand()
                if g[1:] not in amr_genes and r < call_noise:
                    if r < call_noise / 2:
                        continue  # dropped call
                    g = ("-" if g[0] == "+" else "+") + g[1:]
                kept_genes.append(g)
                kept_pos.append(p)
            if not kept_genes:
                kept_genes, kept_pos = read_genes, pos
            read_genes, pos = kept_genes, kept_pos
        rid = f"read{i}"
        calls[rid] = read_genes
        positions[rid] = pos
        fastq[rid] = {"sequence": seq, "quality": "I" * len(seq)}

    os.makedirs(tmpdir, exist_ok=True)
    calls_path = os.path.join(tmpdir, "calls.json")
    pos_path = os.path.join(tmpdir, "positions.json")
    fastq_path = os.path.join(tmpdir, "reads.fastq.gz")
    with open(calls_path, "w") as o:
        json.dump(calls, o)
    with open(pos_path, "w") as o:
        json.dump(positions, o)
    # level 1: the default (9) made compression most of the generation time
    with gzip.open(fastq_path, "wt", compresslevel=1) as o:
        for rid, v in fastq.items():
            o.write(f"@{rid}\n{v['sequence']}\n+\n{v['quality']}\n")

    # species assets: for each AMR gene, the true allele + a diverged variant
    fasta_lines = []
    amr_calls = {}
    for g in amr_genes:
        true_allele = f"{g}.NG001.1"
        var_allele = f"{g}.NG002.1"
        fasta_lines.append(f">{g};{true_allele}")
        fasta_lines.append(gene_seqs[g])
        variant = mutate(rng, gene_seqs[g], sub=0.03, indel=0.0)
        fasta_lines.append(f">{g};{var_allele}")
        fasta_lines.append(variant)
        amr_calls[true_allele] = f"{g} reference phenotype"
        amr_calls[var_allele] = f"{g} variant phenotype"
    amr_fasta = os.path.join(tmpdir, "AMR_alleles_unified.fa")
    with open(amr_fasta, "w") as o:
        o.write("\n".join(fasta_lines))
    amr_calls_path = os.path.join(tmpdir, "AMR_calls.json")
    with open(amr_calls_path, "w") as o:
        json.dump(amr_calls, o)
    core_path = os.path.join(tmpdir, "core_genes.txt")
    with open(core_path, "w") as o:
        o.write("\n".join(g for g in set(layout) if g not in amr_genes))
    plasmid_path = os.path.join(tmpdir, "plasmid_genes.txt")
    with open(plasmid_path, "w") as o:
        o.write("")
    # ground truth for accuracy measurement (accuracy_run.py): the true
    # nucleotide sequence of every AMR allele and its genomic copy count
    truth_path = os.path.join(tmpdir, "truth.json")
    with open(truth_path, "w") as o:
        json.dump(
            {
                "allele_seqs": {g: gene_seqs[g] for g in amr_genes},
                "copy_counts": {
                    g: layout.count(g) for g in amr_genes
                },
                "sub": sub,
                "indel": indel,
            },
            o,
        )
    return {
        "truth": truth_path,
        "calls": calls_path,
        "positions": pos_path,
        "fastq": fastq_path,
        "amr_fasta": amr_fasta,
        "amr_calls": amr_calls_path,
        "core_genes": core_path,
        "plasmid_genes": plasmid_path,
        "gene_seqs": gene_seqs,
        "layout": layout,
        "n_reads": n_reads,
    }

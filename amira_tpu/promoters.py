"""Promoter genotyping: re-polish against <gene>_promoter references and
report SNP/ins/del strings (reference result_utils.py:768-935,
--promoter-mutations, E. coli).

Mutation strings follow the reference's format: `A12G` (SNP at ref position
12), `12IACG` (insertion after position 12), `12-14DACG` (deletion of ref
positions 12-14).
"""

from __future__ import annotations

import json
import os
import sys

from amira_tpu.ops.align import Aligner
from amira_tpu.results import compare_reads_to_references


def _mutations_from_alignment(aln, query_seq, ref_seq):
    """Walk an =/X/I/D cigar into reference-coordinate mutation strings."""
    changes = []
    qi, ri = aln.q_start, aln.r_start
    for op, n in aln.cigar:
        if op == "=":
            qi += n
            ri += n
        elif op == "X":
            for t in range(n):
                ref_base = ref_seq[ri + t].upper()
                read_base = query_seq[qi + t].upper()
                changes.append(f"{ref_base}{ri + t + 1}{read_base}")
            qi += n
            ri += n
        elif op == "I":
            ins = query_seq[qi : qi + n].upper()
            if ri > 0:
                changes.append(f"{ri}I{ins}")
            qi += n
        elif op == "D":
            del_start = ri + 1
            del_end = ri + n
            del_seq = ref_seq[ri : ri + n].upper()
            changes.append(f"{del_start}-{del_end}D{del_seq}")
            ri += n
    return changes


def genotype_promoters(
    result_rows,
    reference_alleles,
    output_dir,
    phenotypes_path,
    fastq_content,
    debug,
    output_components,
):
    if not any("_promoter" in a for a in reference_alleles):
        sys.stderr.write("\namira-tpu: No promoters found in reference FASTA.\n")
        return result_rows
    with open(phenotypes_path) as i:
        phenotypes = json.load(i)
    result_rows = list(result_rows)
    for row in list(result_rows):
        amira_gene = "_".join(row["Amira allele"].split("_")[:-1])
        promoter_name = amira_gene + "_promoter"
        if promoter_name not in reference_alleles:
            continue
        gene_index = row["Amira allele"].split("_")[-1]
        promoter_allele_name = f"{promoter_name}_{gene_index}"
        # reuse the reads assigned to the gene's allele cluster: read the
        # allele fastq written earlier
        from amira_tpu.io import parse_fastq

        allele_fastq = os.path.join(
            output_dir, row["Amira allele"], f"{row['Amira allele']}.fastq.gz"
        )
        if not os.path.exists(allele_fastq):
            continue
        allele_reads = parse_fastq(allele_fastq)
        # feed reads directly (already sliced +/-250bp)
        tagged = [
            f"{rid}_0_{len(v['sequence']) - 1}" for rid, v in allele_reads.items()
        ]
        closest_reference = compare_reads_to_references(
            promoter_allele_name,
            tagged,
            output_dir,
            reference_alleles,
            {rid: v for rid, v in allele_reads.items()},
            phenotypes,
            0.9,
            0.9,
            debug=debug,
        )
        final_fasta = os.path.join(
            output_dir, promoter_allele_name, "06.final_sequence.fasta"
        )
        if not os.path.exists(final_fasta):
            continue
        identity = closest_reference["Identity (%)"]
        if isinstance(identity, str):  # "x/y" multi-tie rows
            identity = float(identity.split("/")[0])
        if not identity < 100:
            continue  # promoter identical to the reference: nothing to report
        with open(final_fasta) as i:
            content = i.read().split("\n")
        polished = "".join(content[1:])
        refs = reference_alleles[promoter_name]
        aligner = Aligner(refs, band_width=256)
        hits = aligner.map_sequence(polished)
        rows = []
        for ref, (_strand, aln) in hits.items():
            changes = _mutations_from_alignment(aln, polished, refs[ref])
            if not changes:
                continue
            gene_name = ref.split(".")[0] + "_promoter_" + "_".join(changes)
            accession = ".".join(ref.split(".")[0:2])
            new_row = {
                "Determinant name": gene_name,
                "Sequence name": phenotypes.get(ref, ""),
                "Closest reference": accession,
                "Reference length": closest_reference["Reference length"],
                "Identity (%)": closest_reference["Identity (%)"],
                "Coverage (%)": closest_reference["Coverage (%)"],
                "Cigar string": closest_reference["Cigar string"],
                "Amira allele": promoter_allele_name,
                "Number of reads used for polishing": closest_reference[
                    "Number of reads used for polishing"
                ],
                "Approximate cellular copy number": row[
                    "Approximate cellular copy number"
                ],
            }
            if output_components is True:
                new_row["Component ID"] = row.get("Component ID")
            rows.append(new_row)
        result_rows.extend(rows)
    return result_rows

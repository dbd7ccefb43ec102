"""Allele recovery, copy-number estimation and result assembly.

Reference semantics: amira/result_utils.py. The minimap2/racon/samtools/
jellyfish subprocess pipeline (result_utils.py:259-341, 1050-1141) is
replaced by the in-process device kernels: banded SW alignment
(amira_tpu/ops/align.py), iterated consensus polishing
(amira_tpu/ops/consensus.py) and the canonical k-mer engine
(amira_tpu/ops/kmer.py). Output artifacts (AMR_allele_fastqs/<allele>/
numbered FASTAs, amira_results.tsv) keep the reference's layout and schema.
"""

from __future__ import annotations

import csv
import json
import numbers
import os
import sys

import numpy as np

from amira_tpu.io import write_fasta, write_fastq
from amira_tpu.ops.align import Aligner, reverse_complement
from amira_tpu.ops.consensus import consensus_from_alignments
from amira_tpu.ops.kmer import (
    estimate_depth_for_reads,
    estimate_overall_read_depth,
)


# ----------------------------------------------------------- cluster plumbing


def get_found_genes(clusters_of_interest):
    found = set()
    for component_id in clusters_of_interest:
        for gene in clusters_of_interest[component_id]:
            found.add(gene)
    return found


def add_amr_alleles(
    short_reads, short_read_gene_positions, sample_genesOfInterest, found_genes,
    path_reads,
):
    """<gene>_1 clusters from short reads whose AMR gene got no graph cluster
    (result_utils.py:30-46)."""
    clusters_to_add: dict = {}
    for read_id in short_reads:
        for g in range(len(short_reads[read_id])):
            strandless = short_reads[read_id][g][1:]
            if strandless in sample_genesOfInterest and strandless not in found_genes:
                key = f"{strandless}_1"
                clusters_to_add.setdefault(key, [])
                gene_start, gene_end = short_read_gene_positions[read_id][g]
                clusters_to_add[key].append(f"{read_id}_{gene_start}_{gene_end}")
                path_tuple = (f"+{strandless}_1",)
                path_reads.setdefault(path_tuple, set()).add(read_id)
    return clusters_to_add


def process_reads(
    graph, sample_genesOfInterest, cores, short_reads, short_read_gene_positions,
    overall_mean_node_coverage,
):
    """(result_utils.py:58-81)"""
    clusters_of_interest, path_reads = graph.assign_reads_to_genes(
        sample_genesOfInterest, cores, {}, overall_mean_node_coverage
    )
    found = get_found_genes(clusters_of_interest)
    clusters_to_add = add_amr_alleles(
        short_reads, short_read_gene_positions, sample_genesOfInterest, found,
        path_reads,
    )
    return clusters_to_add, clusters_of_interest, path_reads


# ------------------------------------------------------------ fastq slicing


def slice_reads_for_allele(reads_for_allele, fastq_content):
    """Read subsequences +/- 250 bp around the allele span
    (result_utils.py:99-121)."""
    read_subset: dict = {}
    for r in reads_for_allele:
        parts = r.split("_")
        read_name = "_".join(parts[:-2])
        start, end = int(parts[-2]), int(parts[-1])
        fq = fastq_content[read_name]
        lo = max(0, start - 250)
        hi = min(len(fq["sequence"]) - 1, end + 250)
        seq = fq["sequence"][lo:hi]
        if seq != "":
            read_subset[read_name] = {
                "sequence": seq,
                "quality": fq["quality"][lo:hi],
            }
    return read_subset


def write_allele_fastq(reads_for_allele, fastq_content, output_dir, allele_name):
    read_subset = slice_reads_for_allele(reads_for_allele, fastq_content)
    d = os.path.join(output_dir, "AMR_allele_fastqs", allele_name)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, allele_name + ".fastq.gz")
    write_fastq(path, read_subset)
    return path


def write_path_fastq(reads_for_path, fastq_content, output_dir, path_id):
    read_subset = {
        r: fastq_content[r]
        for r in reads_for_path
        if fastq_content[r]["sequence"] != ""
    }
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"{path_id}.fastq.gz")
    write_fastq(path, read_subset)
    return path


def write_fastqs_for_genes(clusters_of_interest, overall_mean_node_coverage, fastq_content, output_dir):
    """(result_utils.py:1191-1232)"""
    longest_reads_for_genes = []
    supplemented: dict = {}
    allele_component_mapping: dict = {}
    files_to_assemble = []
    for component in clusters_of_interest:
        for gene in clusters_of_interest[component]:
            for allele, reads in clusters_of_interest[component][gene].items():
                files_to_assemble.append(
                    write_allele_fastq(reads, fastq_content, output_dir, allele)
                )
                supplemented[allele] = reads
                allele_component_mapping[allele] = component
                longest = max(
                    ("_".join(r.split("_")[:-2]) for r in reads),
                    key=lambda rn: len(fastq_content[rn]["sequence"]),
                    default=None,
                )
                if longest is not None:
                    longest_reads_for_genes.append(
                        f">{allele}\n{fastq_content[longest]['sequence']}"
                    )
    return (
        longest_reads_for_genes,
        supplemented,
        allele_component_mapping,
        files_to_assemble,
    )


def write_fastqs_for_genes_with_short_reads(
    clusters_to_add, overall_mean_node_coverage, longest_reads_for_genes,
    output_dir, files_to_assemble, fastq_content, supplemented,
    allele_component_mapping,
):
    """(result_utils.py:1162-1188)"""
    for allele, reads in clusters_to_add.items():
        files_to_assemble.append(
            write_allele_fastq(reads, fastq_content, output_dir, allele)
        )
        supplemented[allele] = reads
        allele_component_mapping[allele] = None
        longest = max(
            ("_".join(r.split("_")[:-2]) for r in reads),
            key=lambda rn: len(fastq_content[rn]["sequence"]),
            default=None,
        )
        if longest is not None:
            longest_reads_for_genes.append(
                f">{allele}\n{fastq_content[longest]['sequence']}"
            )
    return longest_reads_for_genes, files_to_assemble


# ------------------------------------------------------------ allele calling


def _ref_pileups(alignments, references):
    """Per-reference coverage span and proportion from read alignments
    (get_ref_allele_pileups, result_utils.py:449-487)."""
    ref_allele_positions = {}
    cov_proportion = {}
    depth = {ref: np.zeros(len(seq), dtype=np.int32) for ref, seq in references.items()}
    for _rid, hits in alignments.items():
        for ref, (_strand, aln) in hits.items():
            # aligned reference positions (deletions excluded)
            ri = aln.r_start
            for op, n in aln.cigar:
                if op in "=X":
                    depth[ref][ri : ri + n] += 1
                    ri += n
                elif op == "D":
                    ri += n
    for ref, d in depth.items():
        nz = np.nonzero(d)[0]
        if len(nz):
            ref_allele_positions[ref] = (int(nz[0]), int(nz[-1]))
        else:
            ref_allele_positions[ref] = (None, None)
        cov_proportion[ref] = float((d != 0).mean()) if len(d) else 0.0
    return ref_allele_positions, cov_proportion


def get_closest_allele_from_reads(alignments, references, ref_cov_proportion, required_coverage):
    """Best reference from read alignments ("reads" mode,
    result_utils.py:345-420)."""
    ref_matching: dict = {}
    ref_covered: dict = {}
    ref_cigars: dict = {}
    unique_reads = set()
    for rid, hits in alignments.items():
        if hits:
            unique_reads.add(rid)
        for ref, (_strand, aln) in hits.items():
            total = len(references[ref])
            prop_matching = aln.matching_bases / total
            if ref not in ref_matching or prop_matching > ref_matching[ref]:
                ref_matching[ref] = prop_matching
                ref_cigars[ref] = aln
            ref_covered[ref] = ref_cov_proportion[ref]
    valid, invalid = [], []
    for ref in ref_matching:
        entry = (
            ref,
            ref_matching[ref],
            len(references[ref]),
            ref_covered[ref],
            ref_cigars[ref].cigar_string(),
            ref_cigars[ref].cigar_tuples(),
        )
        if ref_covered[ref] >= required_coverage - 0.05:
            valid.append(entry)
        else:
            invalid.append(entry)
    valid.sort(key=lambda x: (min(1, x[3]), x[1], x[2]), reverse=True)
    if valid:
        return True, valid, unique_reads
    invalid.sort(key=lambda x: (x[3], x[1]), reverse=True)
    return False, invalid, unique_reads


def get_closest_allele_from_sam(
    sam_path, mapping_type, required_identity, required_coverage,
    ref_cov_proportion=None,
):
    """SAM-file variant of the closest-reference selection, byte-compatible
    with the reference's get_closest_allele (result_utils.py:345-420) — used
    for SAM interop and parity testing against pre-computed alignments."""
    from amira_tpu.io import parse_sam, parse_sam_header_lengths

    ref_lengths_hdr = parse_sam_header_lengths(sam_path)
    ref_covered: dict = {}
    ref_matching: dict = {}
    ref_lengths: dict = {}
    ref_cigarstrings: dict = {}
    ref_cigartuples: dict = {}
    unique_reads = set()
    for read in parse_sam(sam_path):
        if not read.is_mapped:
            continue
        unique_reads.add(read.query_name)
        total_length = ref_lengths_hdr[read.reference_name]
        if read.reference_name not in ref_covered:
            ref_covered[read.reference_name] = 0
            ref_matching[read.reference_name] = 0
            ref_lengths[read.reference_name] = total_length
        matching = sum(n for op, n in read.cigar if op == 7)
        if mapping_type == "reads":
            prop_matching = matching / total_length
            prop_covered = ref_cov_proportion[read.reference_name]
        else:  # "allele"
            # infer_read_length: every query-consuming op incl. hard clips
            read_len = sum(
                n for op, n in read.cigar if op in (0, 1, 4, 5, 7, 8)
            )
            prop_matching = matching / read_len if read_len else 0
            aligned = sum(n for op, n in read.cigar if op in (0, 1, 7, 8))
            prop_covered = aligned / total_length
        if prop_matching > ref_matching[read.reference_name]:
            ref_matching[read.reference_name] = prop_matching
            ref_cigarstrings[read.reference_name] = _cigar_to_string(read.cigar)
            ref_cigartuples[read.reference_name] = read.cigar
        if prop_covered > ref_covered[read.reference_name]:
            ref_covered[read.reference_name] = prop_covered
    valid, invalid = [], []
    for ref in ref_matching:
        entry = (
            ref, ref_matching[ref], ref_lengths[ref], ref_covered[ref],
            ref_cigarstrings[ref], ref_cigartuples[ref],
        )
        if ref_covered[ref] >= required_coverage - 0.05:
            valid.append(entry)
        else:
            invalid.append(entry)
    valid.sort(key=lambda x: (min(1, x[3]), x[1], x[2]), reverse=True)
    if valid:
        return True, valid, unique_reads
    invalid.sort(key=lambda x: (x[3], x[1]), reverse=True)
    return False, invalid, unique_reads


_CIGAR_CHARS = "MIDNSHP=X"


def _cigar_to_string(cigar_tuples):
    return "".join(f"{n}{_CIGAR_CHARS[op]}" for op, n in cigar_tuples)


def get_closest_allele_from_polished(
    polished_seq, references, required_coverage, band_width=256
):
    """Best reference for the polished allele ("allele" mode,
    result_utils.py:345-420, 557-570): references are partitioned into
    coverage-valid (>= required_coverage - 0.05) and invalid sets, and the
    tie set is taken from the valid set when any exists."""
    aligner = Aligner(references, band_width=band_width)
    hits = aligner.map_sequence(polished_seq)
    return polished_entries_from_hits(hits, references, required_coverage)


def polished_entries_from_hits(hits, references, required_coverage):
    """Entry list for pre-computed polished->reference hits (shared between
    the one-shot and batched allele pipelines)."""
    valid, invalid = [], []
    for ref, (_strand, aln) in hits.items():
        total = len(references[ref])
        prop_matching = aln.matching_bases / aln.q_len
        prop_covered = (aln.q_end - aln.q_start) / total
        entry = (
            ref,
            prop_matching,
            total,
            prop_covered,
            aln.cigar_string(),
            aln.cigar_tuples(),
            aln,
        )
        if prop_covered >= required_coverage - 0.05:
            valid.append(entry)
        else:
            invalid.append(entry)
    if valid:
        valid.sort(key=lambda x: (min(1, x[3]), x[1], x[2]), reverse=True)
        return valid
    invalid.sort(key=lambda x: (x[3], x[1]), reverse=True)
    return invalid


def _identity_from_cigartuples(cigartuples):
    matching = sum(n for op, n in cigartuples if op == 7)
    total = sum(n for op, n in cigartuples if op != 4 and op != 5)
    return matching / total if total else 0.0


def compare_reads_to_references(
    allele_name,
    reads_for_allele,
    output_dir,
    reference_genes,
    fastq_content,
    phenotypes,
    required_identity,
    required_coverage,
    band_width=256,
    debug=False,
):
    """Per-allele polish-and-match pipeline (result_utils.py:494-725).

    Returns the result-row dict with the reference's column schema.
    """
    gene_name = "_".join(allele_name.split("_")[:-1])
    out_dir = os.path.join(output_dir, allele_name)
    os.makedirs(out_dir, exist_ok=True)
    references = reference_genes[gene_name]
    write_fasta(
        os.path.join(out_dir, "01.reference_alleles.fasta"),
        [f">{a}\n{s}" for a, s in references.items()],
    )
    reads = slice_reads_for_allele(reads_for_allele, fastq_content)
    read_seqs = {r: v["sequence"] for r, v in reads.items()}
    aligner = Aligner(references, band_width=band_width)
    alignments = aligner.map_reads(read_seqs)
    for rid in read_seqs:
        alignments.setdefault(rid, {})
    ref_allele_positions, ref_cov_proportion = _ref_pileups(alignments, references)
    validity, refs_sorted, unique_reads = get_closest_allele_from_reads(
        alignments, references, ref_cov_proportion, required_coverage
    )
    if validity:
        valid_allele = refs_sorted[0][0]
        valid_allele_sequence = references[valid_allele]
        first_base, last_base = ref_allele_positions[valid_allele]
        draft = valid_allele_sequence[first_base : last_base + 1]
        write_fasta(
            os.path.join(out_dir, "03.sequence_to_polish.fasta"),
            [f">{valid_allele}\n{draft}"],
        )
        # 5 polish iterations against re-alignment (racon equivalent)
        seq = draft
        for _ in range(5):
            draft_aligner = Aligner({"draft": seq}, band_width=band_width)
            alns = []
            for rid, h in draft_aligner.map_reads(read_seqs).items():
                if "draft" in h:
                    strand, aln = h["draft"]
                    rseq = read_seqs[rid]
                    oriented = rseq if strand == "+" else reverse_complement(rseq)
                    alns.append((strand, aln, oriented))
            if not alns:
                break
            new_seq = consensus_from_alignments(seq, alns)
            if new_seq == seq:
                break
            seq = new_seq
        polished = seq
        write_fasta(
            os.path.join(out_dir, "04.polished_sequence.fasta"),
            [f">{valid_allele}\n{polished}"],
        )
        entries = get_closest_allele_from_polished(
            polished, references, required_coverage, band_width
        )
        row = _row_from_polished(
            out_dir, gene_name, allele_name, polished, entries,
            unique_reads, phenotypes,
        )
        if row is not None:
            return row
    return _row_fallback(
        gene_name, allele_name, refs_sorted, unique_reads, phenotypes
    )


def _row_from_polished(
    out_dir, gene_name, allele_name, polished, entries, unique_reads, phenotypes
):
    """Result row for a successfully polished allele, or None when no
    reference aligned to the polished sequence (result_utils.py:566-671)."""
    if not entries:
        return None
    max_similarity = entries[0][1]
    ties = [e for e in entries if e[1] == max_similarity]
    if len(ties) == 1:
        (closest_allele, _mp, match_length, coverage_proportion,
         cigarstring, cigartuple, _aln) = ties[0]
        write_fasta(
            os.path.join(out_dir, "06.final_sequence.fasta"),
            [f">{closest_allele}\n{polished}"],
        )
        try:
            gene_out = closest_allele.split(".")[0]
            closest_ref = closest_allele.split(".")[1]
        except IndexError:
            gene_out = gene_name
            closest_ref = closest_allele
        phenotype = phenotypes.get(closest_allele, "")
        identity = _identity_from_cigartuples(cigartuple)
        return {
            "Determinant name": gene_out,
            "Sequence name": phenotype,
            "Closest reference": closest_ref,
            "Reference length": match_length,
            "Identity (%)": round(identity * 100, 1),
            "Coverage (%)": min(100.0, round(coverage_proportion * 100, 1)),
            "Cigar string": cigarstring,
            "Amira allele": allele_name,
            "Number of reads used for polishing": len(unique_reads),
        }
    names, lens, covs, cigs, idents = [], [], [], [], []
    for e in ties:
        names.append(e[0])
        lens.append(e[2])
        covs.append(e[3])
        cigs.append(e[4])
        idents.append(_identity_from_cigartuples(e[5]))
    write_fasta(
        os.path.join(out_dir, "06.final_sequence.fasta"),
        [f">{'/'.join(names)}\n{polished}"],
    )
    try:
        gene_names = "/".join(sorted({c.split(".")[0] for c in names}))
        closest_refs = "/".join(c.split(".")[1] for c in names)
    except IndexError:
        gene_names = gene_name
        closest_refs = "/".join(names)
    phen = "/".join(phenotypes.get(c, "") for c in names)
    return {
        "Determinant name": gene_names,
        "Sequence name": phen,
        "Closest reference": closest_refs,
        "Reference length": "/".join(str(m) for m in lens),
        "Identity (%)": "/".join(str(round(p * 100, 1)) for p in idents),
        "Coverage (%)": "/".join(
            str(min(100.0, round(p * 100, 1))) for p in covs
        ),
        "Cigar string": "/".join(cigs),
        "Amira allele": allele_name,
        "Number of reads used for polishing": len(unique_reads),
    }


def _row_fallback(gene_name, allele_name, refs_sorted, unique_reads, phenotypes):
    """Partial result row when no coverage-valid reference or no polished
    alignment exists (result_utils.py:672-725)."""
    if refs_sorted:
        (invalid_allele, _mp, match_length, coverage_proportion, cigarstring,
         cigartuple) = refs_sorted[0]
        try:
            gene_out = invalid_allele.split(".")[0]
            closest_ref = invalid_allele.split(".")[1]
        except IndexError:
            gene_out = gene_name
            closest_ref = invalid_allele
        phenotype = phenotypes.get(invalid_allele, "")
        identity = _identity_from_cigartuples(cigartuple)
        return {
            "Determinant name": gene_out,
            "Sequence name": phenotype,
            "Closest reference": closest_ref,
            "Reference length": match_length,
            "Identity (%)": round(identity * 100, 1),
            "Coverage (%)": min(100.0, round(coverage_proportion * 100, 1)),
            "Cigar string": cigarstring,
            "Amira allele": allele_name,
            "Number of reads used for polishing": len(unique_reads),
        }
    return {
        "Determinant name": "",
        "Sequence name": "",
        "Closest reference": "",
        "Reference length": 0,
        "Identity (%)": 0,
        "Coverage (%)": 0,
        "Cigar string": "",
        "Amira allele": allele_name,
        "Number of reads used for polishing": len(unique_reads),
    }


def get_alleles(
    supplemented_clusters,
    output_dir,
    reference_genes,
    phenotypes_path,
    fastq_content,
    required_identity,
    required_coverage,
    debug=False,
):
    """Polish-and-match every allele cluster (result_utils.py:728-765).

    All alleles run in lockstep so each stage (reads->references mapping, the
    five polish iterations, polished->references matching) batches its
    alignment jobs across every cluster into shared device launches — the
    batched replacement for the reference's joblib process fan-out
    (result_utils.py:746-764).
    """
    with open(phenotypes_path) as i:
        phenotypes = json.load(i)
    base = os.path.join(output_dir, "AMR_allele_fastqs")
    band_width = 256
    SEP = "\x00"

    # ---- stage 1: slice reads, write reference FASTAs, map reads against
    # each cluster's gene references in one shared launch set. The shared
    # reference universe is namespaced per gene (gene SEP allele), so two
    # genes reusing an allele name with different sequences batch fine —
    # no serial fallback.
    state: dict = {}
    union_refs: dict = {}
    all_read_seqs: dict = {}
    subsets: dict = {}
    for allele_name, reads_for_allele in supplemented_clusters.items():
        gene_name = "_".join(allele_name.split("_")[:-1])
        out_dir = os.path.join(base, allele_name)
        os.makedirs(out_dir, exist_ok=True)
        references = reference_genes[gene_name]
        write_fasta(
            os.path.join(out_dir, "01.reference_alleles.fasta"),
            [f">{a}\n{s}" for a, s in references.items()],
        )
        reads = slice_reads_for_allele(reads_for_allele, fastq_content)
        read_seqs = {r: v["sequence"] for r, v in reads.items()}
        state[allele_name] = {
            "gene": gene_name,
            "out_dir": out_dir,
            "references": references,
            "read_seqs": read_seqs,
        }
        for a, s in references.items():
            union_refs[f"{gene_name}{SEP}{a}"] = s
        for rid, seq in read_seqs.items():
            key = f"{allele_name}{SEP}{rid}"
            all_read_seqs[key] = seq
            subsets[key] = [f"{gene_name}{SEP}{a}" for a in references]
    union_aligner = Aligner(union_refs, band_width=band_width)
    all_hits = union_aligner.map_reads(all_read_seqs, ref_subsets=subsets)

    def _strip_gene(hits):
        return {name.split(SEP, 1)[1]: v for name, v in hits.items()}

    rows_by_allele: dict = {}
    active: dict = {}  # allele -> current draft (still polishing)
    for allele_name, st in state.items():
        alignments = {}
        for rid in st["read_seqs"]:
            alignments[rid] = _strip_gene(
                all_hits.get(f"{allele_name}{SEP}{rid}", {})
            )
        ref_allele_positions, ref_cov_proportion = _ref_pileups(
            alignments, st["references"]
        )
        validity, refs_sorted, unique_reads = get_closest_allele_from_reads(
            alignments, st["references"], ref_cov_proportion, required_coverage
        )
        st["refs_sorted"] = refs_sorted
        st["unique_reads"] = unique_reads
        if validity:
            valid_allele = refs_sorted[0][0]
            first_base, last_base = ref_allele_positions[valid_allele]
            draft = st["references"][valid_allele][first_base : last_base + 1]
            write_fasta(
                os.path.join(st["out_dir"], "03.sequence_to_polish.fasta"),
                [f">{valid_allele}\n{draft}"],
            )
            st["valid_allele"] = valid_allele
            st["draft_offset"] = first_base
            active[allele_name] = draft
        else:
            rows_by_allele[allele_name] = _row_fallback(
                st["gene"], allele_name, refs_sorted, unique_reads, phenotypes
            )

    # ---- stage 2: five polish iterations, all active alleles per launch.
    # Band placement carries over between iterations (each read's previous
    # alignment centers its band on the next draft), so the per-iteration
    # work is exactly one batched DP+traceback launch set — no re-seeding,
    # no per-draft seed indexes (result_utils.py:285-335,541-556).
    targets: dict = {}  # read key -> (allele, strand, diag vs current draft)
    for allele_name in active:
        st = state[allele_name]
        valid_allele = st["valid_allele"]
        for rid in st["read_seqs"]:
            h = all_hits.get(f"{allele_name}{SEP}{rid}", {})
            h = _strip_gene(h)
            hit = h.get(valid_allele)
            if hit is None and h:
                # no stage-1 hit on the chosen reference: borrow the best
                # other allele's placement (homologous coordinates)
                hit = max(h.values(), key=lambda sa: sa[1].score)
            if hit is None:
                continue
            strand, aln = hit
            # draft = reference[first:last+1]; stage-1 coords shift by first
            fb = st["draft_offset"]
            targets[f"{allele_name}{SEP}{rid}"] = (
                allele_name, strand, aln.r_start - fb - aln.q_start
            )
    for _ in range(5):
        if not active:
            break
        draft_aligner = Aligner(
            {a: d for a, d in active.items()}, band_width=band_width
        )
        it_reads: dict = {}
        it_targets: dict = {}
        for allele_name in active:
            for rid, seq in state[allele_name]["read_seqs"].items():
                key = f"{allele_name}{SEP}{rid}"
                tgt = targets.get(key)
                if tgt is None:
                    continue
                it_reads[key] = seq
                it_targets[key] = tgt
        hits = draft_aligner.map_with_diagonals(it_reads, it_targets)
        alns_by_allele: dict = {a: [] for a in active}
        for key, h in hits.items():
            allele_name = key.split(SEP, 1)[0]
            if allele_name in h:
                strand, aln = h[allele_name]
                seq = it_reads[key]
                oriented = seq if strand == "+" else reverse_complement(seq)
                alns_by_allele[allele_name].append((strand, aln, oriented))
                targets[key] = (allele_name, strand, aln.r_start - aln.q_start)
        for allele_name in list(active):
            alns = alns_by_allele[allele_name]
            if not alns:
                state[allele_name]["polished"] = active.pop(allele_name)
                continue
            old = active[allele_name]
            new_seq = consensus_from_alignments(old, alns)
            if new_seq == old:
                state[allele_name]["polished"] = active.pop(allele_name)
            else:
                active[allele_name] = new_seq
                # proportional band-shift for the next draft's coordinates
                if len(old):
                    dlen = len(new_seq) - len(old)
                    for rid in state[allele_name]["read_seqs"]:
                        key = f"{allele_name}{SEP}{rid}"
                        tgt = targets.get(key)
                        if tgt is not None:
                            _a, s, diag = tgt
                            shift = dlen * max(diag, 0) // len(old)
                            targets[key] = (_a, s, diag + shift)
    for allele_name, draft in active.items():
        state[allele_name]["polished"] = draft

    # ---- stage 3: polished -> references, again one shared launch set
    polished_seqs: dict = {}
    polished_subsets: dict = {}
    for allele_name, st in state.items():
        if "polished" not in st:
            continue
        write_fasta(
            os.path.join(st["out_dir"], "04.polished_sequence.fasta"),
            [f">{st['valid_allele']}\n{st['polished']}"],
        )
        polished_seqs[allele_name] = st["polished"]
        polished_subsets[allele_name] = [
            f"{st['gene']}{SEP}{a}" for a in st["references"]
        ]
    final_hits = union_aligner.map_reads(
        polished_seqs, ref_subsets=polished_subsets
    )
    for allele_name, st in state.items():
        if "polished" not in st:
            continue
        entries = polished_entries_from_hits(
            _strip_gene(final_hits.get(allele_name, {})),
            st["references"],
            required_coverage,
        )
        row = _row_from_polished(
            st["out_dir"], st["gene"], allele_name, st["polished"], entries,
            st["unique_reads"], phenotypes,
        )
        if row is None:
            row = _row_fallback(
                st["gene"], allele_name, st["refs_sorted"], st["unique_reads"],
                phenotypes,
            )
        rows_by_allele[allele_name] = row
    return [rows_by_allele[a] for a in supplemented_clusters]


# --------------------------------------------------------------- copy number


def estimate_copy_numbers(
    fastq_content, path_reads, amira_alleles, output_dir, k=15, debug=False
):
    """k-mer-depth copy numbers per allele path
    (result_utils.py:1089-1159), via the on-device k-mer engine."""
    import time as _time

    t_start = _time.time()
    outdir = os.path.join(output_dir, "AMR_allele_fastqs", "path_reads")
    os.makedirs(outdir, exist_ok=True)
    path_mapping: dict = {}
    path_list = list(path_reads.keys())
    for i, path in enumerate(path_list):
        path_mapping[i + 1] = list(path)
        write_path_fastq(path_reads[path], fastq_content, outdir, i + 1)
    with open(os.path.join(outdir, "path_id_mapping.json"), "w") as o:
        o.write(json.dumps(path_mapping))
    t0 = _time.time()
    all_seqs = [v["sequence"] for v in fastq_content.values()]
    read_depth, counter = estimate_overall_read_depth(all_seqs, k)
    t1 = _time.time()
    sys.stderr.write(f"\namira-tpu: estimated k-mer depth = {read_depth}.\n")
    sys.stderr.write(
        f"\namira-tpu: copy-number stages: path_fastqs={t0 - t_start:.1f}s"
        f" count+cutoff+histo={t1 - t0:.1f}s"
    )
    gene_counts: dict = {}
    for i, path in path_mapping.items():
        gene_counts[i] = {}
        for g in path:
            strandless = g[1:]
            if strandless in amira_alleles:
                gene = "_".join(strandless.split("_")[:-1])
                gene_counts[i][gene] = gene_counts[i].get(gene, 0) + 1
    t2 = _time.time()
    normalised_depths: dict = {}
    mean_depth_per_reference: dict = {}
    for path_id, path in path_mapping.items():
        reads = path_reads[path_list[path_id - 1]]
        seqs = [fastq_content[r]["sequence"] for r in reads]
        depth_estimate = estimate_depth_for_reads(counter, seqs)
        for g in path:
            allele_name = g[1:]
            if allele_name not in amira_alleles:
                continue
            gene = "_".join(allele_name.split("_")[:-1])
            normalised_depths[allele_name] = depth_estimate / (
                read_depth * gene_counts[path_id][gene]
            )
            mean_depth_per_reference[allele_name] = depth_estimate / read_depth
    sys.stderr.write(
        f" per_path_queries={_time.time() - t2:.1f}s\n"
    )
    return normalised_depths, mean_depth_per_reference


# ------------------------------------------------------------ result frame


def write_empty_result(output_dir):
    results = "Determinant name\tSequence name\tClosest reference\tReference length\t"
    results += "Identity (%)\tCoverage (%)\tAmira allele\t"
    results += "Number of reads used for polishing\tApproximate cellular copy number\n"
    with open(os.path.join(output_dir, "amira_results.tsv"), "w") as o:
        o.write(results)


def supplement_result_rows(
    rows, copy_numbers, mean_depth_per_reference, longest_read_lengths, debug
):
    """Add the depth / copy-number (and, with debug, longest-read) columns
    to every result row in place."""
    for row in rows:
        allele = row["Amira allele"]
        row["Relative mean read depth"] = mean_depth_per_reference[allele]
        row["Approximate cellular copy number"] = copy_numbers[allele]
        if debug:
            row["Longest read length"] = longest_read_lengths.get(allele, 0)
    return rows


def filter_results(
    rows, min_relative_depth, supplemented_clusters, annotatedReads,
    sample_genesOfInterest, required_identity, required_coverage,
    mean_read_depth, plasmid_genes, meta,
):
    """Identity/coverage/relative-depth filters + comment flags
    (result_utils.py:124-207). Returns the kept rows, each with a
    "Comments" entry."""
    alleles_to_delete = []
    if meta is True:
        skip_depth_filtering = True
        sys.stderr.write(
            "\namira-tpu: skipping filtering by depth (metagenome mode).\n"
        )
    elif mean_read_depth < 20:
        skip_depth_filtering = True
        sys.stderr.write(
            "\namira-tpu: skipping filtering by depth as read depth <20x.\n"
        )
    else:
        skip_depth_filtering = False
    required_coverage = required_coverage * 100
    required_identity = required_identity * 100

    def _leading_float(v):
        # "polished/reference" pairs arrive as "a/b" strings; the leading
        # number is the filter subject (contract: result_utils.py:137-151)
        return float(v.split("/")[0]) if isinstance(v, str) and "/" in v else v

    kept = []
    for row in rows:
        identity = _leading_float(row["Identity (%)"])
        coverage = _leading_float(row["Coverage (%)"])
        if identity < required_identity:
            reason, value = "similarity", identity
        elif coverage < required_coverage:
            reason, value = "coverage", coverage
        elif (
            not skip_depth_filtering
            and row["Relative mean read depth"] < min_relative_depth
        ):
            reason = "relative read depth"
            value = row["Relative mean read depth"]
        else:
            kept.append((row, coverage))
            continue
        allele = row["Amira allele"]
        sys.stderr.write(
            f"\namira-tpu: allele {allele} removed due to "
            f"insufficient {reason} ({value}).\n"
        )
        alleles_to_delete.append(allele)

    # a source read supports the contaminant flag iff every gene it
    # carries is of interest; computed once per distinct source read
    goi_only: dict = {}

    def _source_goi_only(member):
        src = "_".join(member.split("_")[:-2])
        v = goi_only.get(src)
        if v is None:
            v = goi_only[src] = all(
                g[1:] in sample_genesOfInterest
                for g in annotatedReads.get(src, [])
            )
        return v

    for row, coverage in kept:
        flags = []
        if coverage < 90:
            flags.append("Partially present gene.")
        members = supplemented_clusters[row["Amira allele"]]
        if all(_source_goi_only(m) for m in members):
            flags.append("Potential contaminant.")
        row["Comments"] = " ".join(flags)
    for amira_allele in alleles_to_delete:
        del supplemented_clusters[amira_allele]
    return [row for row, _coverage in kept]


def result_columns(rows):
    """Column order of a result table: every key, in order of first
    appearance over the rows."""
    return list(dict.fromkeys(key for row in rows for key in row))


def _tsv_formatter(values):
    """Cell formatter for one column, with the reference's (pandas
    to_csv) rendering: a column of plain integers prints as integers; a
    numeric column that holds a float or a missing cell prints every value
    as a float (repr, so 100 -> "100.0"); any other column prints str().
    Missing cells (and NaN) print empty."""
    present = [v for v in values if v is not None]
    numeric = all(
        isinstance(v, numbers.Real) and not isinstance(v, bool)
        for v in present
    )
    integral = all(isinstance(v, numbers.Integral) for v in present)
    if present and numeric and integral and len(present) == len(values):
        return lambda v: str(int(v))
    if present and numeric:
        return lambda v: "" if v is None or v != v else repr(float(v))
    return lambda v: "" if v is None else str(v)


def write_results_tsv(rows, path, columns=()):
    """amira_results.tsv: rows stable-sorted by determinant name, columns
    in `columns` order followed by any other key the rows carry."""
    columns = list(dict.fromkeys([*columns, *result_columns(rows)]))
    rows = sorted(rows, key=lambda r: r["Determinant name"])
    cells = {c: [row.get(c) for row in rows] for c in columns}
    formats = {c: _tsv_formatter(cells[c]) for c in columns}
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh, delimiter="\t", lineterminator="\n")
        writer.writerow(columns)
        for i in range(len(rows)):
            writer.writerow([formats[c](cells[c][i]) for c in columns])


def output_component_fastqs(output_dir, graph, fastq_content):
    os.makedirs(os.path.join(output_dir, "component_fastqs"), exist_ok=True)
    for component in graph.components():
        hashes = [n.hash for n in graph.get_nodes_in_component(component)]
        reads = graph.collect_reads_in_path(hashes)
        write_fastq(
            os.path.join(output_dir, "component_fastqs", f"{component}.fastq.gz"),
            {r: fastq_content[r] for r in reads},
        )


def write_reads_per_AMR_gene(output_dir, supplemented_clusters):
    final: dict = {}
    for allele in supplemented_clusters:
        final_path = os.path.join(
            output_dir, "AMR_allele_fastqs", allele, "06.final_sequence.fasta"
        )
        fallback = os.path.join(
            output_dir, "AMR_allele_fastqs", allele, "03.sequence_to_polish.fasta"
        )
        ref_name = allele
        for p in (final_path, fallback):
            if os.path.exists(p):
                with open(p) as i:
                    ref_name = i.read().split(" ")[0].replace(">", "")
                if "\n" in ref_name:
                    ref_name = ref_name.split("\n")[0]
                break
        reads = {"_".join(r.split("_")[:-2]) for r in supplemented_clusters[allele]}
        final[f"{allele};{ref_name}"] = list(reads)
    with open(os.path.join(output_dir, "reads_per_amr_gene.json"), "w") as o:
        o.write(json.dumps(final))


def write_pandora_gene_calls(output_dir, gene_position_dict, annotatedReads, outfile_1, outfile_2):
    with open(outfile_1, "w") as o:
        o.write(json.dumps(annotatedReads))
    with open(outfile_2, "w") as o:
        o.write(json.dumps(gene_position_dict))

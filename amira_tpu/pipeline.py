"""End-to-end pipeline orchestration (the reference's __main__.py:417-804).

Stages: ingest pandora SAM/JSON -> gene filtering -> gene-mer graph build ->
trimming/junk removal -> k selection -> iterative cleaning (filter, correct,
tips, bubbles) -> final graph -> AMR path clustering -> per-allele polish +
closest-reference matching -> k-mer copy numbers -> filtered results TSV.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

from amira_tpu.graph_utils import (
    build_graph,
    choose_kmer_size,
    estimate_min_path_coverage,
    get_overall_mean_node_coverages,
    iterative_bubble_popping,
)
from amira_tpu.io import (
    parse_fasta,
    parse_fastq,
    plot_read_length_distribution,
    write_fastq,
    write_modified_fastq,
)
from amira_tpu.preprocess import (
    convert_pandora_output,
    estimate_mean_core_gene_counts,
    load_species_specific_files,
    process_pandora_json,
    process_reference_alleles,
    subsample_reads_and_estimate_read_depth,
)
from amira_tpu.results import (
    estimate_copy_numbers,
    filter_results,
    get_alleles,
    output_component_fastqs,
    process_reads,
    result_columns,
    supplement_result_rows,
    write_empty_result,
    write_fastqs_for_genes,
    write_fastqs_for_genes_with_short_reads,
    write_pandora_gene_calls,
    write_reads_per_AMR_gene,
    write_results_tsv,
)
from amira_tpu.tracing import TIMER, phase
from amira_tpu.graph_cache import GraphBuildCache
from amira_tpu.vocab import GeneVocab


def run_pandora_map(
    pandora_path, panRG_path, readfile, outdir, cores, seed, assembly, species, meta
):
    """Shell out to the external pandora gene caller
    (pre_processing.py:13-35); its SAM/consensus are the ingestion contract."""
    import glob

    command = (
        f"{pandora_path} map -t {cores} --min-gene-coverage-proportion 0.5 "
        f"--max-covg 10000 -o {os.path.join(outdir, 'pandora_output')} "
        f"{panRG_path} {readfile} --rng-seed {seed} "
    )
    if assembly is not None or meta is True:
        command += "--no-gene-coverage-filtering"
    else:
        command += "--min-abs-gene-coverage 1"
    if not os.path.exists(panRG_path):
        sys.stderr.write("\namira-tpu: panRG file does not exist.\n")
        sys.exit(1)
    if ".panidx.zip" not in panRG_path:
        sys.stderr.write("\namira-tpu: panRG file does not end in .panidx.zip.\n")
        sys.exit(1)
    subprocess.run(command, shell=True, check=True)
    pandoraSam = glob.glob(
        os.path.join(outdir, "pandora_output", "*.filtered.sam")
    )[0]
    pandoraConsensus = os.path.join(
        outdir, "pandora_output", "pandora.consensus.fq.gz"
    )
    return pandoraSam, pandoraConsensus


def build_and_correct_graph(
    new_annotatedReads,
    new_gene_position_dict,
    node_min_coverage,
    fastq_content,
    output_dir,
    debug,
    overall_mean_node_coverages,
    cores,
    short_reads,
    short_read_gene_positions,
    sample_genesOfInterest,
    min_path_coverage,
    quiet,
    vocab,
    cache=None,
):
    """k=3 pre-clean + k selection + iterative bubble popping
    (__main__.py:337-414)."""
    graph = build_graph(new_annotatedReads, 3, new_gene_position_dict, vocab, cache)
    short_reads.update(graph.get_short_read_annotations())
    short_read_gene_positions.update(graph.get_short_read_gene_positions())
    graph.remove_low_coverage_components(5)
    graph.filter_graph(node_min_coverage, 1)
    new_annotatedReads, new_gene_position_dict = graph.correct_reads(fastq_content)
    if debug:
        write_pandora_gene_calls(
            output_dir,
            new_gene_position_dict,
            new_annotatedReads,
            os.path.join(output_dir, "mid_correction_gene_calls.json"),
            os.path.join(output_dir, "mid_correction_gene_positions.json"),
        )
    graph = build_graph(new_annotatedReads, 3, new_gene_position_dict, vocab, cache)
    short_reads.update(graph.get_short_read_annotations())
    short_read_gene_positions.update(graph.get_short_read_gene_positions())
    graph.filter_graph(node_min_coverage, 1)
    new_annotatedReads = graph.get_valid_reads_only()
    if len(new_annotatedReads) == 0:
        write_empty_result(output_dir)
        sys.exit(0)
    if not quiet:
        sys.stderr.write("\namira-tpu: selecting a gene-mer size (k).\n")
    geneMer_size = choose_kmer_size(
        overall_mean_node_coverages[3],
        new_annotatedReads,
        cores,
        new_gene_position_dict,
        sample_genesOfInterest,
        vocab,
        cache,
    )
    overall_mean_node_coverage = overall_mean_node_coverages[geneMer_size]
    if not quiet:
        sys.stderr.write(f"\namira-tpu: selected k={geneMer_size}.\n")
        sys.stderr.write(
            f"\namira-tpu: mean node depth = {overall_mean_node_coverage}.\n"
        )
    cleaning_iterations = 30
    new_annotatedReads, new_gene_position_dict = iterative_bubble_popping(
        new_annotatedReads,
        new_gene_position_dict,
        cleaning_iterations,
        geneMer_size,
        cores,
        short_reads,
        short_read_gene_positions,
        fastq_content,
        output_dir,
        node_min_coverage,
        sample_genesOfInterest,
        min_path_coverage,
        vocab,
        quiet,
        cache,
    )
    return (
        new_annotatedReads,
        new_gene_position_dict,
        geneMer_size,
        overall_mean_node_coverage,
    )


def run_pipeline(args) -> None:
    """The full pipeline (reference main(), __main__.py:417-804)."""
    start_time = time.time()
    TIMER.phases.clear()
    import random

    random.seed(args.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    AMR_gene_reference_FASTA, sequence_names, core_genes, plasmid_genes = (
        load_species_specific_files(
            args.species, args.amr_fasta, args.amr_calls, args.core_genes,
            args.plasmid_genes,
        )
    )
    reference_alleles, genesOfInterest = process_reference_alleles(
        AMR_gene_reference_FASTA, args.promoters
    )
    if args.reads is not None:
        if not args.quiet:
            sys.stderr.write("\namira-tpu: loading FASTQ file.\n")
        with phase("load_fastq"):
            fastq_content = parse_fastq(args.reads)
        read_fastq_path, fastq_content = write_modified_fastq(
            fastq_content, args.reads, args.output_dir
        )
    else:
        if not args.quiet:
            sys.stderr.write("\namira-tpu: loading FASTA file.\n")
        fastq_content = parse_fasta(args.assembly)
        read_fastq_path = os.path.join(args.output_dir, "assembly.fq.gz")
        write_fastq(read_fastq_path, fastq_content)

    pandoraSam = args.pandoraSam
    pandoraConsensus = args.pandoraConsensus
    if pandoraSam is None and args.pandoraJSON is None:
        if not args.quiet:
            sys.stderr.write("\namira-tpu: running Pandora map.\n")
        pandoraSam, pandoraConsensus = run_pandora_map(
            args.pandora_path, args.panRG_path, read_fastq_path,
            args.output_dir, args.cores, args.seed, args.assembly,
            args.species, args.meta,
        )

    mean_read_depth = 0.0
    ingest_cm = phase("ingest_gene_calls")
    ingest_cm.__enter__()
    try:
        if args.pandoraJSON:
            annotatedReads, sample_genesOfInterest, gene_position_dict = (
                process_pandora_json(
                    args.pandoraJSON, genesOfInterest, args.gene_positions
                )
            )
            annotatedReads = dict(sorted(annotatedReads.items()))
            pandora_consensus = (
                parse_fastq(args.pandoraConsensus) if args.pandoraConsensus else {}
            )
            mean_read_depth = estimate_mean_core_gene_counts(annotatedReads, core_genes)
            sys.stderr.write(f"\namira-tpu: mean read depth = {mean_read_depth}.\n")
        else:
            pandora_consensus = parse_fastq(pandoraConsensus)
            (
                annotatedReads,
                sample_genesOfInterest,
                gene_position_dict,
                consensus_depths,
            ) = convert_pandora_output(
                pandoraSam,
                pandora_consensus,
                genesOfInterest,
                args.gene_min_coverage,
                args.lower_gene_length_threshold,
                args.upper_gene_length_threshold,
                fastq_content,
            )
            annotatedReads = dict(sorted(annotatedReads.items()))
            if args.sample_reads is True:
                annotatedReads, mean_read_depth = (
                    subsample_reads_and_estimate_read_depth(
                        annotatedReads, args.sample_size, core_genes,
                        args.seed, consensus_depths,
                    )
                )
            else:
                mean_read_depth = estimate_mean_core_gene_counts(
                    annotatedReads, core_genes
                )
            write_pandora_gene_calls(
                args.output_dir,
                gene_position_dict,
                annotatedReads,
                os.path.join(args.output_dir, "gene_calls_with_gene_filtering.json"),
                os.path.join(args.output_dir, "gene_positions_with_gene_filtering.json"),
            )
            sys.stderr.write(
                f"\namira-tpu: mean read depth across core genes = {mean_read_depth}.\n"
            )

    finally:
        ingest_cm.__exit__(None, None, None)
    if len(sample_genesOfInterest) == 0:
        write_empty_result(args.output_dir)
        sys.exit(0)
    if args.debug:
        plot_read_length_distribution(annotatedReads, args.output_dir)

    vocab = GeneVocab()
    build_cache = GraphBuildCache()

    def _mesh_build(reads_d, kk, pos_d):
        """Initial/final builds can run distributed: reads shard over a
        data-parallel device mesh and the full node/edge/incidence tables
        are collective-merged (parallel/distgraph.py), producing a graph
        identical to the single-device build."""
        import jax
        from jax.sharding import Mesh

        import numpy as _np
        from amira_tpu.parallel.distgraph import distributed_graph_build

        devs = jax.devices()
        mesh = Mesh(_np.array(devs).reshape(len(devs)), ("data",))
        return distributed_graph_build(
            reads_d, kk, mesh, vocab=vocab, gene_positions=pos_d
        )

    # Distributed builds are the DEFAULT on multi-device hosts (the result
    # is byte-identical to single-device; tests/test_pipeline.py pins it);
    # --no-dist-build opts out, single-device hosts fall back automatically.
    use_dist = getattr(args, "dist_build", None)
    if use_dist is None:
        use_dist = True
    if use_dist:
        import jax

        if len(jax.devices()) < 2:
            use_dist = False
    if not args.quiet:
        sys.stderr.write("\namira-tpu: building initial gene-mer graph.\n")
    with phase("initial_graph_build", items=len(annotatedReads), unit="reads"):
        if use_dist:
            graph = _mesh_build(annotatedReads, 3, gene_position_dict)
        else:
            graph = build_graph(annotatedReads, 3, gene_position_dict, vocab, build_cache)
    if args.debug:
        for node in graph.all_nodes():
            graph.color_node(node, sample_genesOfInterest)
        graph.generate_gml(
            os.path.join(args.output_dir, "pre_correction_gene_mer_graph"),
            3, 1, 1,
        )
        graph.get_unitigs_in_graph(
            os.path.join(args.output_dir, "pre_correction_unitigs.txt")
        )
    overall_mean_node_coverages = get_overall_mean_node_coverages(graph)
    short_reads = graph.get_short_read_annotations()
    short_read_gene_positions = graph.get_short_read_gene_positions()
    if not args.no_trim:
        graph.remove_non_AMR_associated_nodes(sample_genesOfInterest)
        new_annotatedReads, new_gene_position_dict = graph.correct_reads(
            fastq_content
        )
        graph = build_graph(new_annotatedReads, 3, new_gene_position_dict, vocab, build_cache)
    else:
        new_annotatedReads = dict(annotatedReads)
        new_gene_position_dict = dict(gene_position_dict)
    try:
        min_path_coverage = estimate_min_path_coverage(
            graph.get_all_node_coverages(),
            os.path.join(args.output_dir, "initial_node_coverages.png")
            if args.debug
            else None,
        )
    except (ValueError, IndexError):
        min_path_coverage = 10
    node_min_coverage = args.node_min_coverage
    if args.reads is not None and args.meta is False:
        graph.filter_graph(2, 1)
        new_annotatedReads, new_gene_position_dict, _rej, _rejp = (
            graph.remove_junk_reads(0.80)
        )
    if not args.quiet:
        sys.stderr.write(
            "\namira-tpu: removing low coverage components and nodes with "
            f"coverage < {node_min_coverage}.\n"
        )
    if args.reads is not None:
        with phase(
            "graph_cleaning", items=len(new_annotatedReads), unit="reads"
        ):
            (
                new_annotatedReads,
                new_gene_position_dict,
                geneMer_size,
                overall_mean_node_coverage,
            ) = build_and_correct_graph(
                new_annotatedReads,
                new_gene_position_dict,
                node_min_coverage,
                fastq_content,
                args.output_dir,
                args.debug,
                overall_mean_node_coverages,
                args.cores,
                short_reads,
                short_read_gene_positions,
                sample_genesOfInterest,
                min_path_coverage,
                args.quiet,
                vocab,
                build_cache,
            )
    else:
        geneMer_size = 3
        overall_mean_node_coverage = overall_mean_node_coverages[3]

    if not args.quiet:
        sys.stderr.write("\namira-tpu: building corrected gene-mer graph.\n")
    with phase("final_graph_build", items=len(new_annotatedReads), unit="reads"):
        if use_dist:
            graph = _mesh_build(
                new_annotatedReads, geneMer_size, new_gene_position_dict
            )
        else:
            graph = build_graph(
                new_annotatedReads, geneMer_size, new_gene_position_dict,
                vocab, build_cache,
            )
    write_pandora_gene_calls(
        args.output_dir,
        new_gene_position_dict,
        new_annotatedReads,
        os.path.join(args.output_dir, "corrected_gene_calls.json"),
        os.path.join(args.output_dir, "corrected_gene_positions.json"),
    )
    short_reads.update(graph.get_short_read_annotations())
    short_read_gene_positions.update(graph.get_short_read_gene_positions())
    if args.reads is not None:
        graph.remove_low_coverage_components(5)
    if args.debug:
        for node in graph.all_nodes():
            graph.color_node(node, sample_genesOfInterest)
        graph.get_unitigs_in_graph(
            os.path.join(args.output_dir, "post_correction_unitigs.txt")
        )
    if not args.quiet:
        sys.stderr.write("\namira-tpu: writing gene-mer graph.\n")
    graph.generate_gml(
        os.path.join(args.output_dir, "gene_mer_graph"),
        geneMer_size,
        node_min_coverage,
        1,
    )
    if args.output_components is True:
        output_component_fastqs(args.output_dir, graph, fastq_content)
    if not args.quiet:
        sys.stderr.write("\namira-tpu: clustering reads.\n")
    with phase("path_clustering", items=len(sample_genesOfInterest), unit="genes"):
        clusters_to_add, clusters_of_interest, path_reads = process_reads(
            graph,
            sample_genesOfInterest,
            args.cores,
            short_reads,
            short_read_gene_positions,
            overall_mean_node_coverage,
        )
    os.makedirs(os.path.join(args.output_dir, "AMR_allele_fastqs"), exist_ok=True)
    if not args.quiet:
        sys.stderr.write("\namira-tpu: writing fastqs.\n")
    (
        longest_reads_for_genes,
        supplemented_clusters,
        allele_component_mapping,
        files_to_assemble,
    ) = write_fastqs_for_genes(
        clusters_of_interest, overall_mean_node_coverage, fastq_content,
        args.output_dir,
    )
    longest_reads_for_genes, files_to_assemble = (
        write_fastqs_for_genes_with_short_reads(
            clusters_to_add,
            overall_mean_node_coverage,
            longest_reads_for_genes,
            args.output_dir,
            files_to_assemble,
            fastq_content,
            supplemented_clusters,
            allele_component_mapping,
        )
    )
    longest_read_lengths = {}
    for row in longest_reads_for_genes:
        longest_read_lengths[row.split("\n")[0].replace(">", "")] = len(
            "".join(row.split("\n")[1:])
        )
    if not args.quiet:
        sys.stderr.write("\namira-tpu: obtaining nucleotide sequences.\n")
    with phase(
        "allele_polishing", items=len(supplemented_clusters), unit="alleles"
    ):
        result_rows = get_alleles(
            supplemented_clusters,
            args.output_dir,
            reference_alleles,
            sequence_names,
            fastq_content,
            args.identity,
            args.coverage,
            args.debug,
        )
    if len(result_rows) == 0:
        write_empty_result(args.output_dir)
        sys.exit(0)
    if args.reads is not None and args.assembly is None and args.meta is False:
        if not args.quiet:
            sys.stderr.write("\namira-tpu: estimating cellular copy numbers.\n")
        with phase("copy_number_estimation", items=len(path_reads), unit="paths"):
            copy_numbers, mean_depth_per_reference = estimate_copy_numbers(
                fastq_content,
                path_reads,
                {row["Amira allele"] for row in result_rows},
                args.output_dir,
                15,
                args.debug,
            )
    else:
        if not args.quiet:
            sys.stderr.write(
                "\namira-tpu: skipping cellular copy number estimation.\n"
            )
        copy_numbers, mean_depth_per_reference = {}, {}
        for row in result_rows:
            copy_numbers[row["Amira allele"]] = "N/A"
            mean_depth_per_reference[row["Amira allele"]] = "N/A"
    if args.assemble_paths is True:
        from amira_tpu.assembly import assemble_full_length_paths

        assemble_full_length_paths(args.output_dir, args.cores)
    supplement_result_rows(
        result_rows, copy_numbers, mean_depth_per_reference,
        longest_read_lengths, args.debug,
    )
    if args.output_components is True:
        for row in result_rows:
            row["Component ID"] = allele_component_mapping[row["Amira allele"]]
    # the header keeps every column even when the filters drop every row
    columns = result_columns(result_rows) + ["Comments"]
    result_rows = filter_results(
        result_rows,
        args.min_relative_depth,
        supplemented_clusters,
        annotatedReads,
        sample_genesOfInterest,
        args.identity,
        args.coverage,
        mean_read_depth,
        plasmid_genes,
        args.meta,
    )
    if args.promoters:
        from amira_tpu.promoters import genotype_promoters

        result_rows = genotype_promoters(
            result_rows,
            reference_alleles,
            os.path.join(args.output_dir, "AMR_allele_fastqs"),
            sequence_names,
            fastq_content,
            args.debug,
            args.output_components,
        )
    if args.debug:
        write_reads_per_AMR_gene(args.output_dir, supplemented_clusters)
    write_results_tsv(
        result_rows, os.path.join(args.output_dir, "amira_results.tsv"), columns
    )
    TIMER.finish(args.output_dir, args.quiet)
    if not args.quiet:
        sys.stderr.write(
            f"\namira-tpu: total runtime {round(time.time() - start_time)} seconds.\n"
        )

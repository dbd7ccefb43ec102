"""CLI entry point: `python -m amira_tpu` (the reference's console script,
amira/__main__.py:53-289). Flags mirror the reference's surface, including
mode-derived overrides (--meta/--assembly force coverage thresholds down)."""

from __future__ import annotations

import argparse

from amira_tpu import __version__


def get_options(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="amira-tpu",
        description="Identify acquired AMR genes from bacterial long read "
        "sequences (JAX engine).",
    )
    parser.add_argument("--pandoraSam", dest="pandoraSam", help=argparse.SUPPRESS, default=None)
    parser.add_argument("--pandoraJSON", dest="pandoraJSON", help=argparse.SUPPRESS, default=None)
    parser.add_argument("--gene-positions", help=argparse.SUPPRESS, default=None)
    parser.add_argument(
        "--pandoraConsensus", dest="pandoraConsensus", help=argparse.SUPPRESS,
        required=False, default=None,
    )
    parser.add_argument("--reads", dest="reads", help="path to FASTQ file of long reads.", default=None)
    parser.add_argument("--assembly", dest="assembly", help="path to FASTA of assembly.", default=None)
    parser.add_argument(
        "--species",
        dest="species",
        choices=[
            "Escherichia_coli",
            "Klebsiella_pneumoniae",
            "Enterococcus_faecium",
            "Streptococcus_pneumoniae",
            "Staphylococcus_aureus",
            "ESKAPEES",
        ],
        help="The species you want to run on.",
        required=True,
    )
    parser.add_argument(
        "--panRG-path", dest="panRG_path",
        help="Path to pandora panRG ending .panidx.zip.", default=None,
    )
    parser.add_argument(
        "--output", dest="output_dir", type=str, default="amira_output",
        help="Directory for outputs (default=amira_output).",
    )
    parser.add_argument(
        "-n", dest="node_min_coverage", type=int, default=3,
        help="Minimum threshold for gene-mer coverage in the graph (default=3).",
    )
    parser.add_argument(
        "-g", dest="gene_min_coverage", type=float, default=0.2,
        help="Minimum relative threshold to remove all instances of a gene (default=0.2).",
    )
    parser.add_argument(
        "--minimum-length-proportion", dest="lower_gene_length_threshold",
        type=float, default=0.5,
        help="Minimum length threshold to filter a gene from a read (default=0.5).",
    )
    parser.add_argument(
        "--maximum-length-proportion", dest="upper_gene_length_threshold",
        type=float, default=1.5,
        help="Maximum length threshold to filter a gene from a read (default=1.5).",
    )
    parser.add_argument(
        "--sample-size", dest="sample_size", type=int, default=500000,
        help="Number of reads to subsample to (default=500,000).",
    )
    parser.add_argument(
        "--promoter-mutations", dest="promoters", action="store_true",
        default=False,
        help="Genotype the promoter sequences of certain AMR genes.",
    )
    parser.add_argument(
        "--identity", dest="identity", type=float, default=0.9,
        help="Minimum identity to a reference allele to report an AMR gene (default=0.9).",
    )
    parser.add_argument(
        "--coverage", dest="coverage", type=float, default=0.9,
        help="Minimum alignment coverage of a reference allele (default=0.9).",
    )
    parser.add_argument(
        "--min-relative-depth", dest="min_relative_depth", type=float, default=0.2,
        help="Minimum relative read depth to keep an AMR gene (default=0.2).",
    )
    parser.add_argument("--cores", dest="cores", type=int, default=1, help="Number of CPUs (default=1).")
    parser.add_argument(
        "--pandora-path", dest="pandora_path", default="pandora",
        help="Path to pandora binary (default=pandora).",
    )
    parser.add_argument("--seed", dest="seed", type=int, default=2025, help="Set the seed (default=2025).")
    parser.add_argument(
        "--no-sampling", dest="sample_reads", action="store_false", default=True,
        help="Do not randomly sample to a maximum of 500,000 input reads.",
    )
    parser.add_argument("--quiet", dest="quiet", action="store_true", default=False)
    parser.add_argument("--debug", dest="debug", action="store_true", default=False)
    parser.add_argument(
        "--no-trim", dest="no_trim", action="store_true", default=False,
        help="Prevent trimming of the graph (default=False).",
    )
    parser.add_argument(
        "--assemble-paths", dest="assemble_paths", action="store_true", default=False,
        help="Assemble the full reads assigned to each AMR gene copy "
        "(requires an external assembler; optional).",
    )
    parser.add_argument(
        "--meta", dest="meta", action="store_true", default=False,
        help="Do not apply any filtering of genes based on coverage.",
    )
    parser.add_argument(
        "--output-component-fastqs", dest="output_components",
        action="store_true", default=False,
    )
    parser.add_argument("--amr-fasta", dest="amr_fasta", help=argparse.SUPPRESS, default=None)
    parser.add_argument(
        "--dist-build",
        dest="dist_build",
        action="store_true",
        default=None,
        help="Shard the initial/final graph builds over all visible devices "
        "(collective-merged full tables; identical output). DEFAULT when "
        ">=2 devices are visible; --no-dist-build opts out.",
    )
    parser.add_argument(
        "--no-dist-build",
        dest="dist_build",
        action="store_false",
        help="Force single-device graph builds even on multi-device hosts.",
    )
    parser.add_argument("--amr-calls", dest="amr_calls", help=argparse.SUPPRESS, default=None)
    parser.add_argument("--core-genes", dest="core_genes", help=argparse.SUPPRESS, default=None)
    parser.add_argument("--plasmid-genes", dest="plasmid_genes", help=argparse.SUPPRESS, default=None)
    parser.add_argument("--version", action="version", version="%(prog)s v" + __version__)
    args = parser.parse_args(argv)
    if args.pandoraJSON and not args.gene_positions:
        parser.error("--gene-positions is required when --pandoraJSON is used.")
    if not args.reads and not args.assembly:
        parser.error("Either --reads or --assembly is required.")
    if args.reads and args.assembly:
        parser.error("Only one of --reads or --assembly can be specified at a time.")
    if args.pandoraSam is None and args.pandoraJSON is None and args.panRG_path is None:
        parser.error(
            "--panRG-path is required unless --pandoraSam or --pandoraJSON is given."
        )
    if args.meta is True or args.assembly is not None:
        args.node_min_coverage = 1
        args.gene_min_coverage = 0
        args.min_relative_depth = 0
    return args


def main(argv=None) -> None:
    from amira_tpu.pipeline import run_pipeline

    args = get_options(argv)
    run_pipeline(args)


if __name__ == "__main__":
    main()

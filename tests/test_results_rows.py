"""The result table as plain rows: filter outcomes and the TSV writer's
rendering (byte-identical to the committed golden, tests/test_pipeline.py)."""

import copy

from amira_tpu.results import filter_results, result_columns, write_results_tsv


def _row(allele, ident, cov, depth):
    return {
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
    }


def test_filter_results_outcomes_and_comments():
    cases = [
        ("mphA_1", 99.0, 100.0, 1.0),      # kept, clean
        ("mphA_2", 80.0, 100.0, 1.0),      # deleted: identity
        ("dfrA17_1", 99.0, 50.0, 1.0),     # deleted: coverage
        ("dfrA17_2", "95.0/88.0", "92.0/70.0", 1.0),  # kept, split values
        ("dfrA17_3", 99.0, 85.0, 1.0),     # kept, partial-presence flag
        ("mphA_3", 99.0, 100.0, 0.01),     # deleted: relative depth
        ("mphA_4", 99.0, 100.0, 1.0),      # kept, contaminant flag
    ]
    rows = [_row(*c) for c in cases]
    supplemented = {a: [f"r{a}_0_99"] for a, *_ in cases}
    annotated = {f"r{a}": ["+mphA", "+coreGene"] for a, *_ in cases}
    annotated["rmphA_4"] = ["+mphA", "-dfrA17"]
    kept = filter_results(
        copy.deepcopy(rows), 0.2, supplemented, annotated,
        {"mphA", "dfrA17"}, 0.9, 0.8, 30.0, set(), False,
    )
    assert [r["Amira allele"] for r in kept] == [
        "mphA_1", "dfrA17_2", "dfrA17_3", "mphA_4"
    ]
    assert [r["Comments"] for r in kept] == [
        "", "", "Partially present gene.", "Potential contaminant.",
    ]
    assert set(supplemented) == {r["Amira allele"] for r in kept}


def test_tsv_renders_column_kinds(tmp_path):
    rows = [
        {"Determinant name": "b", "n": 3, "f": 1, "s": 7, "opt": 4},
        {"Determinant name": "a", "n": 12, "f": 0.5, "s": "1/2"},
        {"Determinant name": "b", "n": 1, "f": 2.0, "s": "x", "opt": 6},
    ]
    path = tmp_path / "t.tsv"
    write_results_tsv(rows, str(path), result_columns(rows) + ["Comments"])
    assert path.read_text() == (
        "Determinant name\tn\tf\ts\topt\tComments\n"
        "a\t12\t0.5\t1/2\t\t\n"  # missing cells are empty
        "b\t3\t1.0\t7\t4.0\t\n"  # stable sort; int+missing -> floats
        "b\t1\t2.0\tx\t6.0\t\n"
    )


def test_tsv_header_survives_empty_table(tmp_path):
    path = tmp_path / "t.tsv"
    write_results_tsv([], str(path), ["Determinant name", "Comments"])
    assert path.read_text() == "Determinant name\tComments\n"

"""Isolate-level batch driver: N isolates per host, one stream per device."""

import json
import os

import pandas as pd
import pytest

from synthetic import make_isolate


def _entry(files, name, outdir):
    return {
        "name": name,
        "pandoraJSON": files["calls"],
        "gene-positions": files["positions"],
        "reads": files["fastq"],
        "species": "Escherichia_coli",
        "amr-fasta": files["amr_fasta"],
        "amr-calls": files["amr_calls"],
        "core-genes": files["core_genes"],
        "plasmid-genes": files["plasmid_genes"],
        "output": os.path.join(outdir, name),
        "quiet": True,
    }


def test_batch_runs_two_isolates_over_devices(tmp_path):
    from amira_tpu.batch import run_batch

    outdir = str(tmp_path / "out")
    manifest = [
        _entry(make_isolate(str(tmp_path / "iso1"), seed=0, n_reads=60), "iso1", outdir),
        _entry(make_isolate(str(tmp_path / "iso2"), seed=3, n_reads=60), "iso2", outdir),
    ]
    summaries = run_batch(manifest, workers=2, quiet=True)
    assert [s["status"] for s in summaries] == ["ok", "ok"]
    for s in summaries:
        df = pd.read_csv(s["results_tsv"], sep="\t")
        assert len(df) == 1
        assert df.iloc[0]["Determinant name"] == "amrX"


def test_batch_cli_manifest(tmp_path):
    from amira_tpu.batch import main

    outdir = str(tmp_path / "out")
    manifest = [
        _entry(make_isolate(str(tmp_path / "iso1"), seed=1, n_reads=60), "iso1", outdir)
    ]
    mpath = str(tmp_path / "manifest.json")
    with open(mpath, "w") as fh:
        json.dump(manifest, fh)
    main([mpath, "--workers", "1", "--quiet"])
    assert os.path.exists(os.path.join(outdir, "iso1", "amira_results.tsv"))


def _broken_entry(tmp_path):
    return {
        "name": "broken",
        "pandoraJSON": "/does/not/exist.json",
        "gene-positions": "/does/not/exist_pos.json",
        "reads": "/does/not/exist.fastq",
        "species": "Escherichia_coli",
        "amr-fasta": "/does/not/exist.fa",
        "output": str(tmp_path / "broken"),
        "quiet": True,
    }


def test_batch_survives_one_bad_isolate(tmp_path):
    """A failing isolate records an error summary instead of sinking the
    batch (one bad manifest entry must not discard completed isolates)."""
    from amira_tpu.batch import run_batch

    manifest = [_broken_entry(tmp_path)]
    summaries = run_batch(manifest, str(tmp_path), workers=1, quiet=True)
    assert len(summaries) == 1
    assert summaries[0]["status"].startswith("error:")


def test_batch_cli_exits_nonzero_when_an_isolate_fails(tmp_path, capsys):
    """The CLI still finishes the batch, then reports the failure in its
    exit status."""
    from amira_tpu.batch import main

    outdir = str(tmp_path / "out")
    manifest = [
        _entry(make_isolate(str(tmp_path / "iso1"), seed=1, n_reads=60), "iso1", outdir),
        _broken_entry(tmp_path),
    ]
    mpath = str(tmp_path / "manifest.json")
    with open(mpath, "w") as fh:
        json.dump(manifest, fh)
    with pytest.raises(SystemExit) as e:
        main([mpath, "--workers", "1", "--quiet"])
    assert e.value.code == 1
    statuses = [s["status"] for s in json.loads(capsys.readouterr().out)]
    assert statuses[0] == "ok" and statuses[1].startswith("error:")

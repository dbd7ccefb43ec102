"""Multi-isolate batch driver — isolate-level data parallelism on one host
(BASELINE config 4: 32 ESKAPE+E. coli isolates per host).

The reference processes one isolate per CLI invocation (amira/__main__.py);
there is no batch mode. Production batches want the expensive, shared state
loaded once: species assets and reference alleles are read per isolate but
every kernel shape compiles exactly once for the whole batch (persistent jit
cache + pow2 shape bucketing), and when several accelerator devices are
visible, isolates round-robin across them via jax.default_device — each
device runs an independent isolate stream, the isolate-level analogue of
data parallelism (cross-isolate collective work is unnecessary: isolates
share nothing).

Usage:
    python -m amira_tpu.batch manifest.json [--workers N] [--output-root DIR]

The manifest is a JSON list; each entry is a dict of CLI flags for one
isolate, exactly as accepted by `python -m amira_tpu` (long names without
the leading dashes), e.g.:

    [{"name": "iso1", "pandoraJSON": "...", "gene-positions": "...",
      "reads": "...", "species": "Escherichia_coli", "output": "out/iso1"},
     ...]

`name` is optional (defaults to isolate_<i>) and is used for the output
subdirectory when `output` is not given explicitly.
"""

from __future__ import annotations

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def _entry_to_argv(entry: dict, output_root: str | None, idx: int) -> list[str]:
    entry = dict(entry)
    name = entry.pop("name", f"isolate_{idx}")
    if "output" not in entry:
        root = output_root or "amira_batch_output"
        entry["output"] = os.path.join(root, name)
    argv: list[str] = []
    for key, value in entry.items():
        flag = f"--{key}" if len(key) > 1 else f"-{key}"
        if value is True:
            argv.append(flag)
        elif value is False or value is None:
            continue
        else:
            argv += [flag, str(value)]
    return argv


def run_isolate(argv: list[str], device=None) -> dict:
    """Run one isolate's pipeline, optionally pinned to a device. A pinned
    stream builds its graphs on that device alone: the other devices run
    other streams, so a mesh over all of them is not this stream's to use."""
    import jax

    from amira_tpu.__main__ import get_options
    from amira_tpu.pipeline import run_pipeline

    args = get_options(argv)
    if device is not None:
        args.dist_build = False
    start = time.time()
    status = "ok"
    try:
        if device is not None:
            with jax.default_device(device):
                run_pipeline(args)
        else:
            run_pipeline(args)
    except SystemExit as e:
        # the pipeline exits 0 early when no AMR genes survive — that is a
        # valid per-isolate outcome, not a batch failure
        status = "ok" if e.code in (None, 0) else f"exit {e.code}"
    except Exception as e:  # noqa: BLE001 — one bad isolate must not sink the batch
        status = f"error: {type(e).__name__}: {e}"
        sys.stderr.write(f"\namira-tpu batch: isolate failed ({status}): {argv}\n")
    return {
        "output": args.output_dir,
        "status": status,
        "seconds": round(time.time() - start, 2),
        "results_tsv": os.path.join(args.output_dir, "amira_results.tsv"),
    }


def run_batch(
    manifest: list[dict],
    output_root: str | None = None,
    workers: int | None = None,
    quiet: bool = False,
) -> list[dict]:
    """Process every isolate in the manifest; returns per-isolate summaries.

    workers defaults to the visible device count: one isolate stream per
    device. Threads suffice — device dispatch releases the GIL, so streams
    overlap device work; host-side Python sections serialize, which matches
    the reference's single-process behavior per isolate.
    """
    import jax

    devices = jax.devices()
    if workers is None:
        workers = len(devices)
    workers = max(1, min(workers, len(manifest)))
    jobs = [
        (_entry_to_argv(entry, output_root, i), devices[i % len(devices)])
        for i, entry in enumerate(manifest)
    ]
    t0 = time.time()
    if workers == 1:
        summaries = [run_isolate(argv, dev) for argv, dev in jobs]
    else:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            summaries = list(
                pool.map(lambda j: run_isolate(j[0], j[1]), jobs)
            )
    wall = time.time() - t0
    if not quiet:
        done = sum(1 for s in summaries if s["status"] == "ok")
        sys.stderr.write(
            f"\namira-tpu batch: {done}/{len(summaries)} isolates in "
            f"{wall:.1f}s over {workers} stream(s) on {len(devices)} "
            f"device(s).\n"
        )
    return summaries


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(
        prog="amira-tpu-batch",
        description="Process a batch of isolates (one device stream each); "
        "exits 1 when any isolate failed.",
    )
    parser.add_argument("manifest", help="JSON list of per-isolate CLI flag dicts")
    parser.add_argument("--workers", type=int, default=None)
    parser.add_argument("--output-root", dest="output_root", default=None)
    parser.add_argument("--quiet", action="store_true", default=False)
    args = parser.parse_args(argv)
    with open(args.manifest) as fh:
        manifest = json.load(fh)
    summaries = run_batch(
        manifest, args.output_root, args.workers, args.quiet
    )
    print(json.dumps(summaries, indent=2))
    if any(s["status"] != "ok" for s in summaries):
        raise SystemExit(1)


if __name__ == "__main__":
    main()

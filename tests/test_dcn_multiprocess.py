"""True two-process DCN execution of the hierarchical 3D merge.

Every other multi-chip proof in this suite runs on a single-process virtual
mesh where the ("host", "data", "table") mesh's "host" axis merely MODELS
the DCN boundary. Here two actual OS processes (4 virtual CPU devices each)
join a `jax.distributed.initialize` cluster and run
make_distributed_genemer_step_3d across the REAL process boundary — the
cross-host all_gather is a genuine cross-process collective. Skips cleanly
if this jaxlib lacks multi-process CPU collectives support.

Reference merge semantics being distributed: amira/graph_utils.py:17-124.
"""

import json
import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_dcn_merge_matches_serial(tmp_path):
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "dcn_worker.py")
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    # the workers run on the CPU backend; clear the suite's 8-device flag
    # so each worker gets its own 4
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    outs = [str(tmp_path / f"dcn_{i}.json") for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), str(port), outs[i]],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for i in range(2)
    ]
    rcs, logs = [], []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.skip("multi-process CPU collectives hung; unsupported")
        rcs.append(p.returncode)
        logs.append(err)
    if any(rc != 0 for rc in rcs):
        blob = "\n".join(logs)
        if (
            "distributed" in blob.lower()
            or "collective" in blob.lower()
            or "gloo" in blob.lower()
            or "UNIMPLEMENTED" in blob
        ):
            pytest.skip(
                f"jax.distributed multi-process CPU unsupported here: "
                f"{blob[-500:]}"
            )
        raise AssertionError(f"worker failed:\n{blob[-2000:]}")
    with open(outs[0]) as fh:
        r0 = json.load(fh)
    with open(outs[1]) as fh:
        r1 = json.load(fh)
    assert r0["matches_serial"] is True
    assert r0["total"] == r0["expected_total"] == r1["total"]
    assert r0["n_keys"] == r1["n_keys"] > 0
    # the bin-sharded DNA k-mer table's psum_scatter also crossed the
    # process boundary: each process's bin half equals the host counter
    assert r0["kmer_matches_host"] is True
    assert r1["kmer_matches_host"] is True
    assert r0["kmer_bins_covered"] > 0 and r1["kmer_bins_covered"] > 0

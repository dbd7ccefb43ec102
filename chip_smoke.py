"""Run amira-tpu end to end on one NVIDIA GPU and check every device kernel.

One process does everything, so only this process opens the card. Phases:

  env        JAX version and devices, the card's name and power limit, the
             compile cache, the native host module and libdeflate. Exits 1
             unless JAX's first device is a GPU: there is no CPU mode.
  gpu-tests  `pytest -m gpu tests/` in this process.
  kernels    each device kernel of the main path at real widths against its
             plain reference, with the warm device time of each call. All of
             it is integer arithmetic, so every comparison is exact.
  pipeline   the scale isolate (tests/synthetic.scale_isolate_kwargs) at
             --reads reads through `python -m amira_tpu`'s main(), cold then
             warm. The calls (amrX x2 + amrY, true alleles) and each
             recovered allele's identity to the simulator's truth are checked.

`--four` runs only the two multi-GPU paths, each against its one-card
reference: (a) the default distributed graph build against
--no-dist-build, (b) the batch driver's one isolate stream per device
against each isolate run alone.

The last line of stdout is {"ok": true, "device": {...}}; a failed phase
exits non-zero before it is printed.

Usage: python chip_smoke.py [--reads 100000] [--workdir DIR] [--four]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.join(ROOT, "tests")


class PhaseFailed(RuntimeError):
    pass


def _check(cond, what):
    if not cond:
        raise PhaseFailed(what)


def _warm_ms(fn, *args, repeats=3):
    """Best-of-`repeats` wall time of an already compiled call, ending in
    block_until_ready, in milliseconds."""
    import jax

    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


# ------------------------------------------------------------------ kernels
# Each check runs one kernel of the main path and its plain reference on the
# same inputs, and returns the number of mismatching elements (0 when exact)
# and the warm device time. Cached, so the kernels phase reports what the
# gpu-tests phase already measured instead of running it twice.


def _random_reads(n_reads, genes_per_read, n_genes, seed):
    import numpy as np

    rng = np.random.RandomState(seed)
    lo, hi = genes_per_read
    lengths = rng.randint(lo, hi + 1, size=n_reads).astype(np.int32)
    ids = rng.randint(1, n_genes + 1, size=(n_reads, hi))
    sign = rng.choice(np.array([-1, 1]), size=(n_reads, hi))
    tokens = np.where(
        np.arange(hi)[None, :] < lengths[:, None], ids * sign, 0
    ).astype(np.int32)
    return tokens, lengths


@functools.cache
def check_windows(n_reads=70_000, genes_per_read=(10, 20), k=3, seed=0):
    """Gene-mer windows and edge keys on device (hashing.genemer_windows via
    graph_tables.pack_windows_edges, and graph_tables.pack_flat_windows)
    against the NumPy mirror ops/host_tables.host_windows_edges."""
    import numpy as np

    from amira_tpu.ops.graph_tables import (
        join_u64,
        pack_flat_windows,
        pack_windows_edges,
    )
    from amira_tpu.ops.host_tables import host_windows_edges

    tokens, lengths = _random_reads(n_reads, genes_per_read, 4000, seed)
    R, L = tokens.shape
    tok_list = [tokens[i, : lengths[i]] for i in range(R)]
    host = host_windows_edges(tok_list, k)
    host_h = np.concatenate([h for h, _, _ in host])
    host_d = np.concatenate([d for _, d, _ in host])
    host_e = np.concatenate([e for _, _, e in host])

    buf = np.asarray(pack_windows_edges(tokens, lengths, k))
    W = L - k + 1
    RW, E = R * W, R * 2 * (W - 1)
    h = join_u64(buf[:RW], buf[RW : 2 * RW]).reshape(R, W)
    d = (buf[2 * RW : 3 * RW].astype(np.int8) - 1).reshape(R, W)
    ek = join_u64(buf[3 * RW : 3 * RW + E], buf[3 * RW + E :]).reshape(R, -1)
    wmask = np.arange(W)[None, :] < (lengths - k + 1)[:, None]
    emask = np.arange(2 * (W - 1))[None, :] < (2 * (lengths - k))[:, None]
    bucket_mismatch = (
        np.count_nonzero(h[wmask] != host_h)
        + np.count_nonzero(d[wmask] != host_d)
        + np.count_nonzero(ek[emask] != host_e)
    )

    flat = np.concatenate(tok_list)
    n_flat = 1 << max(12, int(len(flat) - 1).bit_length())
    flat = np.concatenate([flat, np.zeros(n_flat - len(flat), np.int32)])
    fbuf = np.asarray(pack_flat_windows(flat, k))
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    pos = np.concatenate(
        [s + np.arange(n - k + 1) for s, n in zip(starts, lengths)]
    )
    fh = join_u64(fbuf[:n_flat], fbuf[n_flat : 2 * n_flat])[pos]
    fd = fbuf[2 * n_flat :][pos].astype(np.int8) - 1
    flat_mismatch = np.count_nonzero(fh != host_h) + np.count_nonzero(
        fd != host_d
    )
    return {
        "genes": int(lengths.sum()),
        "windows": int(len(host_h)),
        "bucket_mismatches": int(bucket_mismatch),
        "flat_mismatches": int(flat_mismatch),
        "bucket_ms": _warm_ms(pack_windows_edges, tokens, lengths, k),
        "flat_ms": _warm_ms(pack_flat_windows, flat, k),
    }


def _reference_node_tables(occ_hash, occ_read, occ_key):
    """NumPy statement of assemble_node_tables: lexicographic (hash, order
    key) order, run boundaries/coverage, unique (run, read) pairs."""
    import numpy as np

    from amira_tpu.ops.graph_tables import UINT_MAX

    N = len(occ_hash)
    perm = np.lexsort((occ_key, occ_hash))
    sh = occ_hash[perm]
    valid = sh != UINT_MAX
    boundary = valid & np.concatenate([[True], sh[1:] != sh[:-1]])
    run_id = np.cumsum(boundary).astype(np.int32) - 1
    seg = np.where(valid, run_id, N)
    run_cov = np.bincount(seg, weights=valid, minlength=N + 1).astype(
        np.int32
    )[seg]
    huge = np.int32(0x7FFFFFFF)
    read32 = np.where(valid, occ_read[perm].astype(np.int32), huge)
    run32 = np.where(valid, run_id, huge)
    po = np.lexsort((read32, run32))
    prun, pread = run32[po], read32[po]
    pvalid = prun != huge
    pboundary = pvalid & np.concatenate(
        [[True], (prun[1:] != prun[:-1]) | (pread[1:] != pread[:-1])]
    )
    return (
        sh, boundary, occ_key[perm], run_cov, pboundary,
        np.where(pvalid, prun, -1), np.where(pvalid, pread, -1),
    )


def _reference_edge_tables(ekeys, eokey):
    import numpy as np

    from amira_tpu.ops.graph_tables import UINT_MAX

    N = len(ekeys)
    perm = np.lexsort((eokey, ekeys))
    sk = ekeys[perm]
    valid = sk != UINT_MAX
    boundary = valid & np.concatenate([[True], sk[1:] != sk[:-1]])
    run_id = np.cumsum(boundary) - 1
    seg = np.where(valid, run_id, N)
    cov = np.bincount(seg, weights=valid, minlength=N + 1).astype(np.int32)
    return sk, boundary, cov[seg], eokey[perm]


@functools.cache
def check_graph_tables(n_occ=1 << 21, n_reads=100_000, seed=0):
    """assemble_node_tables / assemble_edge_tables (native stable uint64
    sorts) against np.lexsort on the same keys, top bits set included."""
    import numpy as np

    from amira_tpu.ops.graph_tables import (
        UINT_MAX,
        assemble_edge_tables,
        assemble_node_tables,
    )

    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**64 - 1, size=max(n_occ // 16, 2), dtype=np.uint64)
    pool[0] = np.uint64(0xFFFFFFFFFFFFFFFE)
    pool[1] = np.uint64(0x8000000000000001)
    occ_hash = pool[rng.integers(0, len(pool), size=n_occ)]
    occ_read = rng.integers(0, n_reads, size=n_occ).astype(np.int32)
    window = rng.integers(0, 1 << 20, size=n_occ)
    occ_key = (occ_read.astype(np.int64) << 22) | (window << 1)
    invalid = rng.random(n_occ) < 0.05
    occ_hash[invalid] = UINT_MAX
    occ_read[invalid] = -1
    occ_key[invalid] = 2**62

    got = [np.asarray(x) for x in assemble_node_tables(
        occ_hash, occ_read, occ_key, n_reads
    )]
    ref = _reference_node_tables(occ_hash, occ_read, occ_key)
    node_mismatch = sum(
        np.count_nonzero(g != r) for g, r in zip(got, ref)
    )
    egot = [np.asarray(x) for x in assemble_edge_tables(occ_hash, occ_key)]
    eref = _reference_edge_tables(occ_hash, occ_key)
    edge_mismatch = sum(
        np.count_nonzero(g != r) for g, r in zip(egot, eref)
    )
    return {
        "occurrences": n_occ,
        "node_mismatches": int(node_mismatch),
        "edge_mismatches": int(edge_mismatch),
        "node_ms": _warm_ms(
            assemble_node_tables, occ_hash, occ_read, occ_key, n_reads
        ),
        "edge_ms": _warm_ms(assemble_edge_tables, occ_hash, occ_key),
    }


def _sw_batch(B, Lq, W, seed):
    """B noisy (query, reference) pairs laid out as Aligner._run_batch lays
    them out: queries padded to Lq, references at offset W + Lq of a padded
    buffer, band start dlo per job. Every fifth pair is unrelated."""
    import numpy as np

    from amira_tpu.ops.align import _bucket

    rng = np.random.RandomState(seed)
    P = W + Lq
    rlen = _bucket(Lq + 2 * W + 2 * Lq)
    qs = np.full((B, Lq), 4, np.uint8)
    rs = np.full((B, rlen), 4, np.uint8)
    qlens = np.zeros(B, np.int32)
    dlos = np.zeros(B, np.int32)
    for b in range(B):
        n = rng.randint(Lq // 2, Lq + 1)
        r = rng.randint(0, 4, size=n).astype(np.uint8)
        if b % 5 == 4:
            q = rng.randint(0, 4, size=n).astype(np.uint8)
        else:
            x = rng.rand(n)
            q = np.where(x < 0.05, rng.randint(0, 4, size=n), r)
            q = np.delete(q, np.flatnonzero((x >= 0.05) & (x < 0.07)))
            ins = np.flatnonzero((x >= 0.07) & (x < 0.09))
            q = np.insert(q, np.minimum(ins, len(q)), rng.randint(0, 4, len(ins)))
            q = q[:Lq].astype(np.uint8)
        qs[b, : len(q)] = q
        rs[b, P : P + n] = r
        qlens[b] = len(q)
        dlos[b] = int(np.clip(rng.randint(-16, 17) - W // 2, -(Lq - 1), n - 1))
    return qs, rs, qlens, dlos


@functools.cache
def check_sw(B=512, Lq=2048, W=256, seed=0, host_slice=32):
    """Batched banded SW DP + device traceback (align._batched_sw_cigar) on
    the default device against the same jitted function on the CPU backend;
    the host traceback (AMIRA_TPU_DEVICE_TRACEBACK=0 path: align._batched_sw
    + align._traceback) against the device traceback on a slice."""
    import jax
    import numpy as np

    from amira_tpu.ops.align import (
        _banded_sw_batch_core,
        _batched_sw,
        _batched_sw_cigar,
        _preshift_refs,
        _traceback,
        _traceback_batch,
        _unpack_cigar,
    )

    qs, rs, qlens, dlos = _sw_batch(B, Lq, W, seed)
    got = [np.asarray(x) for x in _batched_sw_cigar(qs, rs, qlens, dlos, W)]
    cpu = jax.devices("cpu")[0]
    ref = [
        np.asarray(x)
        for x in _batched_sw_cigar(
            *(jax.device_put(a, cpu) for a in (qs, rs, qlens, dlos)), W
        )
    ]
    mismatch = sum(np.count_nonzero(g != r) for g, r in zip(got, ref))
    packed, n_steps, q0s, r0s, best, bi, bw = got
    mapped = int(np.count_nonzero((bi >= 0) & (best > 0)))

    S = min(host_slice, B)
    tb, hbest, hbi, hbw, hbs = (
        np.asarray(x)
        for x in _batched_sw(qs[:S], rs[:S], qlens[:S], dlos[:S], W)
    )
    host_mismatch = int(
        np.count_nonzero(hbest != best[:S]) + np.count_nonzero(hbi != bi[:S])
    )
    P = W + Lq
    for b in range(S):
        if bi[b] < 0 or best[b] <= 0:
            continue
        cigar, q0, r0, q1, r1 = _traceback(
            tb[b], qs[b, : qlens[b]], rs[b, P:], hbi[b], hbw[b], hbs[b],
            int(dlos[b]),
        )
        dev = (
            _unpack_cigar(packed[b], int(n_steps[b])), int(q0s[b]),
            int(r0s[b]), int(bi[b]) + 1, int(bi[b] + dlos[b] + bw[b]) + 1,
        )
        host_mismatch += int((cigar, q0, r0, q1, r1) != dev)

    dp = jax.jit(
        lambda q, r, ql, dl: _banded_sw_batch_core(
            q, _preshift_refs(r, dl, Lq, W), ql, W
        )
    )
    walk = jax.jit(
        lambda tb, best, bi, bw, bs: _traceback_batch(
            tb, B, Lq, best, bi, bw, bs, W
        )
    )
    dev_in = [jax.device_put(a) for a in (qs, rs, qlens, dlos)]
    dp_out = jax.block_until_ready(dp(*dev_in))
    jax.block_until_ready(walk(*dp_out))
    return {
        "shape": (B, Lq, W),
        "mapped_lanes": mapped,
        "mismatches": int(mismatch),
        "host_traceback_lanes": S,
        "host_traceback_mismatches": host_mismatch,
        "dp_ms": _warm_ms(dp, *dev_in),
        "traceback_ms": _warm_ms(walk, *dp_out),
        "fused_ms": _warm_ms(_batched_sw_cigar, *dev_in, W),
    }


def _kmer_reads(n_codes, read_len, seed):
    """Reads sampled from one random genome with 1% substitutions, so
    k-mer counts have a real depth peak; sum(len) + n_reads ~= n_codes."""
    import numpy as np

    rng = np.random.RandomState(seed)
    n_reads = max(1, n_codes // (read_len + 1))
    genome = rng.randint(0, 4, size=max(n_codes // 50, 4 * read_len))
    starts = rng.randint(0, len(genome) - read_len, size=n_reads)
    codes = genome[starts[:, None] + np.arange(read_len)[None, :]]
    noise = rng.rand(*codes.shape) < 0.01
    codes[noise] = rng.randint(0, 4, size=int(noise.sum()))
    text = np.frombuffer(b"ACGT", np.uint8)[codes].tobytes().decode()
    return [text[i * read_len : (i + 1) * read_len] for i in range(n_reads)]


@functools.cache
def check_dense_kmer(n_codes=1 << 26, k=15, seed=0, n_queries=8):
    """The dense device k-mer counter (_dense_count_chunk fed by the native
    packer, _dense_histo_bincount, _dense_query_median) against
    KmerCounter's host path on the same reads: equal nonzero bins, equal
    histogram, equal per-read-set medians."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from amira_tpu.ops import kmer

    seqs = _kmer_reads(n_codes, 5000, seed)
    dense = kmer.KmerCounter._from_seqs_dense(seqs, k, 0)
    previous = os.environ.get("AMIRA_TPU_KMER_BACKEND")
    os.environ["AMIRA_TPU_KMER_BACKEND"] = "host"
    try:
        host = kmer.KmerCounter.from_sequences(seqs, k)
    finally:
        if previous is None:
            os.environ.pop("AMIRA_TPU_KMER_BACKEND", None)
        else:
            os.environ["AMIRA_TPU_KMER_BACKEND"] = previous
    _check(host.dense is None, "reference counter took the dense path")
    table = np.asarray(dense.dense)[:-1]
    nz = np.flatnonzero(table)
    bin_mismatch = (
        abs(len(nz) - len(host.kmers))
        if len(nz) != len(host.kmers)
        else int(
            np.count_nonzero(nz != host.kmers)
            + np.count_nonzero(table[nz] != host.counts)
        )
    )
    dh, hh = dense.histo(), host.histo()
    histo_mismatch = sum(
        dh.get(c, 0) != hh.get(c, 0) for c in set(dh) | set(hh)
    )
    rng = np.random.RandomState(seed + 1)
    median_mismatch = 0
    for _ in range(n_queries):
        pick = rng.choice(len(seqs), size=min(50, len(seqs)), replace=False)
        subset = [seqs[i] for i in pick]
        median_mismatch += int(
            kmer.estimate_depth_for_reads(dense, subset)
            != kmer.estimate_depth_for_reads(host, subset)
        )

    words, bad = kmer._pack_codes_2bit(kmer._concat_codes(seqs))
    pad = kmer._DENSE_CHUNK // 16 - len(words)
    words = jnp.asarray(np.concatenate([words, np.zeros(pad, np.uint32)]))
    bad = jnp.asarray(np.concatenate([bad, np.full(2 * pad, 255, np.uint8)]))
    count_ms = float("inf")
    for _ in range(3):
        t = jax.block_until_ready(jnp.zeros(4**k + 1, jnp.uint32))
        t0 = time.perf_counter()
        jax.block_until_ready(kmer._dense_count_chunk(t, words, bad, k))
        count_ms = min(count_ms, 1e3 * (time.perf_counter() - t0))
    n_query = min(1 << 18, kmer._DENSE_CHUNK)  # codes in the timed query
    qwords, qbad = words[: n_query // 16], bad[: n_query // 8]
    return {
        "k": k,
        "codes": sum(len(s) + 1 for s in seqs),
        "chunk_codes": kmer._DENSE_CHUNK,
        "distinct_kmers": int(len(nz)),
        "bin_mismatches": int(bin_mismatch),
        "histo_mismatches": int(histo_mismatch),
        "median_mismatches": median_mismatch,
        "count_chunk_ms": count_ms,
        "count_codes_per_s": kmer._DENSE_CHUNK / (count_ms / 1e3),
        "histo_ms": _warm_ms(
            kmer._dense_histo_bincount, dense.dense, kmer._HISTO_CAP
        ),
        "query_ms": _warm_ms(
            kmer._dense_query_median, dense.dense, qwords, qbad, k
        ),
    }


# ----------------------------------------------------------------- pipeline


def _isolate_argv(files, out, *extra):
    return [
        "--pandoraJSON", files["calls"],
        "--gene-positions", files["positions"],
        "--reads", files["fastq"],
        "--species", "Escherichia_coli",
        "--amr-fasta", files["amr_fasta"],
        "--amr-calls", files["amr_calls"],
        "--core-genes", files["core_genes"],
        "--plasmid-genes", files["plasmid_genes"],
        "--output", out,
        "--quiet",
        *extra,
    ]


def _run_main(argv) -> float:
    from amira_tpu.__main__ import main

    t0 = time.perf_counter()
    try:
        main(argv)
    except SystemExit as e:  # the pipeline exits 0 when nothing is found
        if e.code not in (None, 0):
            raise
    return time.perf_counter() - t0


def _read_tsv(out):
    import csv

    with open(os.path.join(out, "amira_results.tsv"), newline="") as fh:
        return list(csv.DictReader(fh, delimiter="\t"))


def check_calls(out, truth_path):
    """amrX x2 + amrY, each on its true allele (NG001), each recovered
    sequence at 100% identity to the simulator's truth."""
    sys.path.insert(0, ROOT)
    from accuracy_run import identity, recovered_allele_seq

    with open(truth_path) as fh:
        truth = json.load(fh)
    rows = _read_tsv(out)
    genes = sorted(r["Determinant name"] for r in rows)
    _check(genes == ["amrX", "amrX", "amrY"], f"calls {genes}")
    idents = {}
    for r in rows:
        _check(r["Closest reference"] == "NG001", f"allele {r}")
        seq = recovered_allele_seq(out, r["Amira allele"])
        idents[r["Amira allele"]] = identity(
            seq or "", truth["allele_seqs"][r["Determinant name"]]
        )
    _check(all(v == 1.0 for v in idents.values()), f"identity {idents}")
    return idents


def generate_isolate(workdir, n_reads, n_genes=4000, seed=17):
    sys.path.insert(0, TESTS)
    from synthetic import make_isolate, scale_isolate_kwargs

    return make_isolate(
        workdir, n_reads=n_reads, **scale_isolate_kwargs(n_genes, seed)
    )


def pipeline_phase(workdir, n_reads, n_genes=4000, seed=17):
    """Generate the isolate, run the CLI's main() cold then warm, check
    both runs' calls. Returns set-up, run times, the warm phase table."""
    t0 = time.perf_counter()
    files = generate_isolate(os.path.join(workdir, "isolate"), n_reads, n_genes, seed)
    setup_s = time.perf_counter() - t0
    result = {"reads": n_reads, "setup_s": setup_s}
    for run in ("cold", "warm"):
        out = os.path.join(workdir, run)
        result[f"{run}_s"] = _run_main(_isolate_argv(files, out))
        result["identity"] = check_calls(out, files["truth"])
    with open(os.path.join(workdir, "warm", "phase_timings.json")) as fh:
        result["phases"] = json.load(fh)
    return result


# ------------------------------------------------------------------ 4 cards


def _graph_counts(out):
    """(nodes, edges) of the corrected gene-mer graph the run wrote."""
    [gml] = [f for f in os.listdir(out) if f.startswith("gene_mer_graph.")]
    with open(os.path.join(out, gml)) as fh:
        lines = fh.read().split("\n")
    return lines.count("\tnode\t["), lines.count("\tedge\t[")


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def four_dist_phase(workdir, files):
    """(a) the default distributed graph build over every device against
    --no-dist-build on one device: identical TSV, node and edge counts."""
    out_dist = os.path.join(workdir, "dist")
    out_one = os.path.join(workdir, "one")
    dist_s = _run_main(_isolate_argv(files, out_dist))
    one_s = _run_main(_isolate_argv(files, out_one, "--no-dist-build"))
    check_calls(out_dist, files["truth"])
    counts = (_graph_counts(out_dist), _graph_counts(out_one))
    _check(counts[0] == counts[1], f"graph (nodes, edges) {counts}")
    _check(
        _same_file(*(os.path.join(o, "amira_results.tsv") for o in (out_dist, out_one))),
        "dist and one-device TSVs differ",
    )
    return {"dist_s": dist_s, "one_s": one_s, "graph": counts[0]}


def four_batch_phase(workdir, isolates):
    """(b) run_batch over the isolates, one stream per device, against each
    isolate run alone on one device: identical TSVs, every status ok."""
    from amira_tpu.batch import run_batch

    manifest = [
        {
            "name": name,
            "pandoraJSON": files["calls"],
            "gene-positions": files["positions"],
            "reads": files["fastq"],
            "species": "Escherichia_coli",
            "amr-fasta": files["amr_fasta"],
            "amr-calls": files["amr_calls"],
            "core-genes": files["core_genes"],
            "plasmid-genes": files["plasmid_genes"],
            "output": os.path.join(workdir, "batch", name),
            "quiet": True,
        }
        for name, files in isolates.items()
    ]
    t0 = time.perf_counter()
    summaries = run_batch(manifest, quiet=True)
    batch_s = time.perf_counter() - t0
    statuses = [s["status"] for s in summaries]
    _check(all(s == "ok" for s in statuses), f"batch statuses {statuses}")
    alone_s = {}
    for name, files in isolates.items():
        out = os.path.join(workdir, "alone", name)
        alone_s[name] = _run_main(_isolate_argv(files, out, "--no-dist-build"))
        _check(
            _same_file(
                os.path.join(out, "amira_results.tsv"),
                os.path.join(workdir, "batch", name, "amira_results.tsv"),
            ),
            f"{name}: batch and alone TSVs differ",
        )
    return {"batch_s": batch_s, "alone_s": alone_s, "statuses": statuses}


def _generate_parallel(jobs):
    """{name: (workdir, n_reads, seed)} -> {name: files}, one spawned
    NumPy-only process each (they never import JAX or touch the card)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(jobs), mp_context=ctx) as pool:
        futures = {
            name: pool.submit(generate_isolate, wd, n, 4000, seed)
            for name, (wd, n, seed) in jobs.items()
        }
        return {name: f.result() for name, f in futures.items()}


# --------------------------------------------------------------------- main


def env_phase(n_cards):
    import ctypes

    import jax

    print(f"jax {jax.__version__}")
    devices = jax.devices()
    for d in devices:
        print(f"device {d.id}: platform={d.platform} kind={d.device_kind}")
    if devices[0].platform != "gpu":
        print(
            f"chip_smoke: JAX's first device is {devices[0].platform!r}, "
            "not a GPU; there is no CPU mode",
            file=sys.stderr,
        )
        raise SystemExit(1)
    _check(len(devices) >= n_cards, f"{n_cards} GPUs needed, {len(devices)} visible")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print("card name, power limit (nvidia-smi):")
    for line in smi.stdout.strip().splitlines():
        print(line.strip())
    print(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    from amira_tpu.native import load

    print(f"native _fastio module: {'loaded' if load() else 'NOT loaded (Python fallbacks)'}")
    found = None
    for lib in ("libdeflate.so.0", "libdeflate.so"):
        try:
            ctypes.CDLL(lib)
        except OSError:
            continue
        found = lib
        break
    print(f"libdeflate: {found or 'not found (zlib streaming FASTQ reader)'}")
    return devices


def gpu_tests_phase():
    import pytest

    # tests import this module as `chip_smoke`: let them share its caches
    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    os.environ["AMIRA_TPU_TESTS_ON_DEVICE"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", TESTS])
    _check(rc == 0, f"pytest -m gpu exited {rc}")


def kernels_phase():
    w = check_windows()
    print(
        f"windows+edge keys ({w['genes']:,} genes, {w['windows']:,} windows):"
        f" mismatches bucket={w['bucket_mismatches']} flat={w['flat_mismatches']};"
        f" pack_windows_edges {w['bucket_ms']:.3f} ms, pack_flat_windows"
        f" {w['flat_ms']:.3f} ms"
    )
    g = check_graph_tables()
    print(
        f"graph tables ({g['occurrences']:,} occurrences): mismatches"
        f" node={g['node_mismatches']} edge={g['edge_mismatches']};"
        f" assemble_node_tables {g['node_ms']:.3f} ms,"
        f" assemble_edge_tables {g['edge_ms']:.3f} ms"
    )
    s = check_sw()
    print(
        f"SW {s['shape']} (B, Lq, W), {s['mapped_lanes']} mapped lanes:"
        f" mismatches vs CPU={s['mismatches']}, host traceback on"
        f" {s['host_traceback_lanes']} lanes={s['host_traceback_mismatches']};"
        f" DP {s['dp_ms']:.3f} ms, traceback {s['traceback_ms']:.3f} ms,"
        f" fused {s['fused_ms']:.3f} ms"
    )
    d = check_dense_kmer()
    print(
        f"dense k-mer k={d['k']} ({d['codes']:,} codes, {d['distinct_kmers']:,}"
        f" distinct): mismatches bins={d['bin_mismatches']}"
        f" histo={d['histo_mismatches']} medians={d['median_mismatches']};"
        f" count chunk ({d['chunk_codes']:,} codes) {d['count_chunk_ms']:.3f} ms"
        f" = {d['count_codes_per_s']:.4g} codes/s, histo {d['histo_ms']:.3f} ms,"
        f" query {d['query_ms']:.3f} ms"
    )
    mismatches = {
        "windows": w["bucket_mismatches"] + w["flat_mismatches"],
        "graph_tables": g["node_mismatches"] + g["edge_mismatches"],
        "sw": s["mismatches"] + s["host_traceback_mismatches"],
        "dense_kmer": d["bin_mismatches"] + d["histo_mismatches"]
        + d["median_mismatches"],
    }
    _check(not any(mismatches.values()), f"kernel mismatches {mismatches}")
    print("kernels: every comparison exact (max difference 0)")


def _print_pipeline(r, device):
    print(
        f"pipeline {r['reads']:,} reads: set-up (generation) {r['setup_s']:.2f} s,"
        f" cold {r['cold_s']:.2f} s, warm {r['warm_s']:.2f} s,"
        f" compilation (cold - warm) {r['cold_s'] - r['warm_s']:.2f} s"
    )
    print(f"calls amrX x2 + amrY, identity to truth: {r['identity']}")
    print("warm phase table:")
    for p in r["phases"]:
        print(f"  {p['phase']:<28s} {p['seconds']:10.3f} s")
    stats = device.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    print(
        "process peak device memory: "
        + (f"{peak / 2**30:.3f} GiB" if peak is not None else "not reported")
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=100_000)
    ap.add_argument(
        "--workdir", default=None,
        help="keep generated isolates and outputs here (default: a "
        "temporary directory, removed at exit)",
    )
    ap.add_argument(
        "--four", action="store_true",
        help="run only the four-GPU paths and their one-GPU references",
    )
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    n_cards = 4 if args.four else 1
    devices = env_phase(n_cards)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        workdir = args.workdir or tmp
        os.makedirs(workdir, exist_ok=True)
        if args.four:
            t0 = time.perf_counter()
            jobs = {"dist": (os.path.join(workdir, "dist_isolate"), args.reads, 17)}
            jobs.update(
                (f"iso{s}", (os.path.join(workdir, f"iso{s}"), 20_000, s))
                for s in (1, 2, 3, 4)
            )
            isolates = _generate_parallel(jobs)
            print(f"set-up (generation, parallel) {time.perf_counter() - t0:.2f} s")
            a = four_dist_phase(os.path.join(workdir, "a"), isolates.pop("dist"))
            print(
                f"(a) {args.reads:,} reads: dist build on {len(devices)} GPUs"
                f" {a['dist_s']:.2f} s (cold), --no-dist-build on one GPU"
                f" {a['one_s']:.2f} s; graph (nodes, edges) {a['graph']} equal,"
                " TSV identical"
            )
            b = four_batch_phase(os.path.join(workdir, "b"), isolates)
            alone = ", ".join(f"{k} {v:.2f} s" for k, v in b["alone_s"].items())
            print(
                f"(b) run_batch of {len(isolates)} x 20,000 reads on"
                f" {len(devices)} GPUs: {b['batch_s']:.2f} s, statuses"
                f" {b['statuses']}; alone on one GPU: {alone}; TSVs identical"
            )
        else:
            print("== gpu-tests")
            gpu_tests_phase()
            print("== kernels")
            kernels_phase()
            print("== pipeline")
            r = pipeline_phase(workdir, args.reads)
            _print_pipeline(r, devices[0])
    d = devices[0]
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": d.platform, "kind": d.device_kind, "count": len(devices),
        },
    }))


if __name__ == "__main__":
    try:
        main()
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        raise SystemExit(1)

"""Data-parallel gene-mer graph statistics over a device mesh.

The reference's only distribution story is joblib shard-merge on one host
(amira/graph_utils.py:17-124): per-shard graphs are built and node coverages
added, edges unioned, read tables unioned. Here the same merge semantics run
as XLA collectives: every device builds a bounded count table (sorted unique
hashes + segment-summed coverages) for its read shard, the tables are
all-gathered over the `data` mesh axis, and a second bounded count merges
them — so gene-mer counting scales over the device interconnect without
any host round-trip.

This module provides the device-side table kernels (also used single-chip by
bench.py) and the shard_map-based distributed step used by
__graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from amira_tpu.ops.hashing import edge_key, genemer_windows

P = jax.sharding.PartitionSpec


def bounded_count(keys, weights, capacity: int):
    """Sorted unique keys + summed weights with a static output capacity.

    keys:     (N,) uint64 (0 = invalid/padding, excluded from the table)
    weights:  (N,) int32
    Returns (table_keys, table_counts): (capacity,) each; unused slots hold
    key 0 / count 0. Requires #unique <= capacity (overflow slots are
    dropped deterministically from the end of the sorted order).
    """
    n = keys.shape[0]
    order = jnp.argsort(keys)
    sk = keys[order]
    sw = weights[order]
    valid = sk != 0
    boundary = jnp.concatenate(
        [valid[:1], (sk[1:] != sk[:-1]) & valid[1:]]
    )
    run_id = jnp.cumsum(boundary.astype(jnp.int32)) - 1  # -1 for invalid prefix
    run_id = jnp.where(valid, run_id, capacity)  # invalid -> overflow slot
    run_id = jnp.minimum(run_id, capacity)
    counts = jax.ops.segment_sum(
        jnp.where(valid, sw, 0), run_id, num_segments=capacity + 1
    )[:capacity]
    table_keys = jnp.zeros((capacity + 1,), dtype=keys.dtype)
    table_keys = table_keys.at[jnp.where(boundary, run_id, capacity)].set(
        jnp.where(boundary, sk, 0)
    )[:capacity]
    return table_keys, counts.astype(jnp.int32)


@partial(jax.jit, static_argnames=("k", "capacity"))
def local_genemer_tables(tokens, lengths, k: int, capacity: int):
    """Per-shard node and edge count tables from a padded read batch."""
    win = genemer_windows(tokens, lengths, k)
    nh = jnp.where(win["valid"], win["node_hash"], 0)
    node_keys, node_counts = bounded_count(
        nh.reshape(-1), jnp.ones(nh.size, jnp.int32), capacity
    )
    nd = win["direction"]
    if nh.shape[1] >= 2:
        src_h, tgt_h = win["node_hash"][:, :-1], win["node_hash"][:, 1:]
        src_d, tgt_d = nd[:, :-1], nd[:, 1:]
        ev = win["valid"][:, :-1] & win["valid"][:, 1:]
        e1 = jnp.where(ev, edge_key(src_h, src_d, tgt_h, tgt_d), 0)
        e2 = jnp.where(ev, edge_key(tgt_h, -tgt_d, src_h, -src_d), 0)
        ekeys = jnp.concatenate([e1.reshape(-1), e2.reshape(-1)])
    else:
        ekeys = jnp.zeros((2,), jnp.uint64)
    edge_keys, edge_counts = bounded_count(
        ekeys, jnp.ones(ekeys.shape[0], jnp.int32), capacity
    )
    return node_keys, node_counts, edge_keys, edge_counts


def make_distributed_genemer_step(mesh, k: int, capacity: int):
    """Build the jitted multi-chip step: reads sharded over the `data` axis,
    per-shard tables merged via all_gather + re-count (the collective
    equivalent of the reference's merge_nodes/merge_edges coverage adds)."""
    shard_map = jax.shard_map

    def shard_step(tokens, lengths):
        win = genemer_windows(tokens, lengths, k)
        nh = jnp.where(win["valid"], win["node_hash"], 0)
        local_keys, local_counts = bounded_count(
            nh.reshape(-1), jnp.ones(nh.size, jnp.int32), capacity
        )
        # merge shard tables over the interconnect: gather every shard's
        # table, re-count
        all_keys = jax.lax.all_gather(local_keys, "data").reshape(-1)
        all_counts = jax.lax.all_gather(local_counts, "data").reshape(-1)
        merged_keys, merged_counts = bounded_count(all_keys, all_counts, capacity)
        # total gene-mer occurrences across the slice (psum sanity statistic)
        total = jax.lax.psum(
            jnp.sum(jnp.where(win["valid"], 1, 0)), "data"
        )
        return merged_keys, merged_counts, total

    step = shard_map(
        shard_step,
        mesh=mesh,
        in_specs=(Pspec_data(), Pspec_data()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(step)


def Pspec_data():
    return P("data")


def make_distributed_genemer_step_2d(mesh, k: int, capacity: int):
    """2D-parallel gene-mer counting over a ("data", "table") mesh.

    Reads shard over BOTH axes (maximum data parallelism); the hash space
    shards over the "table" axis: every device routes each gene-mer hash to
    its owning table shard (hash mod T) with an all_to_all, counts
    its partition, then merges partial tables across the "data" axis with an
    all_gather + re-count. Each device ends up holding the global count table
    for its hash partition — the table-parallel analogue of TP for a count
    table that would not fit one device's memory.
    """
    shard_map = jax.shard_map
    T = mesh.shape["table"]

    def shard_step(tokens, lengths):
        win = genemer_windows(tokens, lengths, k)
        nh = jnp.where(win["valid"], win["node_hash"], 0).reshape(-1)
        # route hashes to their owning table shard: bucket by dest with a
        # fixed per-destination capacity, then all_to_all over "table"
        dest = (nh % jnp.uint64(T)).astype(jnp.int32)
        dest = jnp.where(nh == 0, T, dest)  # invalid -> dropped bucket
        send_cap = max(nh.shape[0] // T * 2, 128)
        order = jnp.argsort(dest, stable=True)
        sd = dest[order]
        sh_sorted = nh[order]
        # position of each element within its destination bucket
        first_of_dest = jnp.searchsorted(sd, jnp.arange(T + 1, dtype=jnp.int32))
        send = jnp.zeros((T, send_cap + 1), dtype=jnp.uint64)
        idx_in_bucket = jnp.arange(sd.shape[0]) - first_of_dest[
            jnp.clip(sd, 0, T)
        ]
        ok = (sd < T) & (idx_in_bucket < send_cap)
        # invalid/overflow elements scatter into the dump column send_cap
        send = send.at[
            jnp.where(ok, sd, 0), jnp.where(ok, idx_in_bucket, send_cap)
        ].set(jnp.where(ok, sh_sorted, 0))
        send = send[:, :send_cap]
        recv = jax.lax.all_to_all(send, "table", 0, 0, tiled=False)
        mine = recv.reshape(-1)
        local_keys, local_counts = bounded_count(
            mine, jnp.ones(mine.shape[0], jnp.int32), capacity
        )
        # merge the data-axis shards of this table partition
        all_keys = jax.lax.all_gather(local_keys, "data").reshape(-1)
        all_counts = jax.lax.all_gather(local_counts, "data").reshape(-1)
        merged_keys, merged_counts = bounded_count(all_keys, all_counts, capacity)
        # every occurrence lands on exactly one (data, table) device after the
        # all_to_all, so the global total sums the pre-merge local tables
        total = jax.lax.psum(
            jax.lax.psum(jnp.sum(local_counts), "table"), "data"
        )
        return merged_keys[None, :], merged_counts[None, :], total

    step = shard_map(
        shard_step,
        mesh=mesh,
        in_specs=(P(("data", "table")), P(("data", "table"))),
        out_specs=(P("table"), P("table"), P()),
        check_vma=False,
    )
    return jax.jit(step)


def make_distributed_genemer_step_3d(mesh, k: int, capacity: int):
    """Hierarchical gene-mer counting over a ("host", "data", "table") mesh —
    the multi-host (BASELINE config 5) layout.

    Axis roles: "host" is the boundary between hosts (the network); "data"
    and "table" are the intra-host axes (the device interconnect). Reads
    shard data-parallel over all three axes. Each device routes hashes to the
    table-partition owner inside its host (all_to_all over "table"), counts
    its partition, then merges the data-axis partials inside the host —
    producing one deduplicated per-host table per partition. Only THEN does
    the "host" axis merge run (all_gather across hosts + re-count):
    hierarchical merging ships deduplicated
    tables across the slow axis instead of raw occurrence streams, which is
    the collective equivalent of the reference's shard merge
    (amira/graph_utils.py:17-102) with its coverage adds.
    """
    shard_map = jax.shard_map
    T = mesh.shape["table"]

    def shard_step(tokens, lengths):
        win = genemer_windows(tokens, lengths, k)
        nh = jnp.where(win["valid"], win["node_hash"], 0).reshape(-1)
        dest = (nh % jnp.uint64(T)).astype(jnp.int32)
        dest = jnp.where(nh == 0, T, dest)
        send_cap = max(nh.shape[0] // T * 2, 128)
        order = jnp.argsort(dest, stable=True)
        sd = dest[order]
        sh_sorted = nh[order]
        first_of_dest = jnp.searchsorted(sd, jnp.arange(T + 1, dtype=jnp.int32))
        send = jnp.zeros((T, send_cap + 1), dtype=jnp.uint64)
        idx_in_bucket = jnp.arange(sd.shape[0]) - first_of_dest[
            jnp.clip(sd, 0, T)
        ]
        ok = (sd < T) & (idx_in_bucket < send_cap)
        send = send.at[
            jnp.where(ok, sd, 0), jnp.where(ok, idx_in_bucket, send_cap)
        ].set(jnp.where(ok, sh_sorted, 0))
        send = send[:, :send_cap]
        recv = jax.lax.all_to_all(send, "table", 0, 0, tiled=False)
        mine = recv.reshape(-1)
        local_keys, local_counts = bounded_count(
            mine, jnp.ones(mine.shape[0], jnp.int32), capacity
        )
        # intra-host merge over the device interconnect
        d_keys = jax.lax.all_gather(local_keys, "data").reshape(-1)
        d_counts = jax.lax.all_gather(local_counts, "data").reshape(-1)
        host_keys, host_counts = bounded_count(d_keys, d_counts, capacity)
        # cross-host merge over the network (deduplicated tables only)
        h_keys = jax.lax.all_gather(host_keys, "host").reshape(-1)
        h_counts = jax.lax.all_gather(host_counts, "host").reshape(-1)
        merged_keys, merged_counts = bounded_count(h_keys, h_counts, capacity)
        total = jax.lax.psum(
            jax.lax.psum(
                jax.lax.psum(jnp.sum(local_counts), "table"), "data"
            ),
            "host",
        )
        return merged_keys[None, :], merged_counts[None, :], total

    step = shard_map(
        shard_step,
        mesh=mesh,
        in_specs=(P(("host", "data", "table")), P(("host", "data", "table"))),
        out_specs=(P("table"), P("table"), P()),
        check_vma=False,
    )
    return jax.jit(step)


def distributed_node_counts_3d(
    read_tokens: np.ndarray, lengths: np.ndarray, k: int, mesh,
    capacity: int = 1 << 16,
):
    """Host entry for the ("host", "data", "table") mesh."""
    n_dev = mesh.devices.size
    R = read_tokens.shape[0]
    pad = (-R) % n_dev
    if pad:
        read_tokens = np.vstack(
            [read_tokens, np.zeros((pad, read_tokens.shape[1]), read_tokens.dtype)]
        )
        lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
    step = make_distributed_genemer_step_3d(mesh, k, capacity)
    sharding = jax.sharding.NamedSharding(mesh, P(("host", "data", "table")))
    keys, counts, total = step(
        jax.device_put(read_tokens, sharding),
        jax.device_put(lengths, sharding),
    )
    keys = np.asarray(keys).reshape(-1)
    counts = np.asarray(counts).reshape(-1)
    mask = keys != 0
    return keys[mask], counts[mask], int(np.asarray(total).reshape(-1)[0])


def scaling_report(
    read_tokens: np.ndarray,
    lengths: np.ndarray,
    k: int = 3,
    capacity: int = 1 << 14,
    repeats: int = 3,
):
    """Weak-scaling efficiency over 1, 2, 4, ... available devices across
    ALL mesh layouts (BASELINE config 5's scaling-efficiency report): the
    pure data-parallel mesh, the 2D (data x table) hash-routed mesh, and the
    3D (host x data x table) hierarchical-merge mesh where enough devices
    exist.

    Returns a list of {mesh, n_devices, reads_per_sec, efficiency} dicts;
    efficiency = throughput / (n * single-device throughput) within each
    mesh family.
    """
    import time

    from jax.sharding import Mesh

    devices = jax.devices()
    rows = []

    def timed(fn, tok, lens):
        fn(tok, lens)  # warm/compile
        best = None
        for _ in range(repeats):
            t0 = time.time()
            fn(tok, lens)
            dt = time.time() - t0
            best = dt if best is None else min(best, dt)
        return tok.shape[0] / best

    # 1D data-parallel
    base = None
    n = 1
    while n <= len(devices):
        mesh = Mesh(np.array(devices[:n]).reshape(n), ("data",))
        tok = np.tile(read_tokens, (n, 1))
        lens = np.tile(lengths, n)
        rps = timed(
            lambda t, ln: distributed_node_counts(t, ln, k, mesh, capacity),
            tok, lens,
        )
        if base is None:
            base = rps
        rows.append(
            {
                "mesh": f"{n} (data)",
                "n_devices": n,
                "reads_per_sec": round(rps, 1),
                "efficiency": round(rps / (n * base), 3),
            }
        )
        n *= 2

    # 2D data x table
    n = 4
    base2 = base  # efficiency vs the same single-device baseline
    while n <= len(devices):
        mesh = Mesh(
            np.array(devices[:n]).reshape(n // 2, 2), ("data", "table")
        )
        tok = np.tile(read_tokens, (n, 1))
        lens = np.tile(lengths, n)
        rps = timed(
            lambda t, ln: distributed_node_counts_2d(t, ln, k, mesh, capacity),
            tok, lens,
        )
        rows.append(
            {
                "mesh": f"{n // 2}x2 (data x table)",
                "n_devices": n,
                "reads_per_sec": round(rps, 1),
                "efficiency": round(rps / (n * base2), 3),
            }
        )
        n *= 2

    # 3D host x data x table
    n = 8
    while n <= len(devices):
        mesh = Mesh(
            np.array(devices[:n]).reshape(2, n // 4, 2),
            ("host", "data", "table"),
        )
        tok = np.tile(read_tokens, (n, 1))
        lens = np.tile(lengths, n)
        rps = timed(
            lambda t, ln: distributed_node_counts_3d(t, ln, k, mesh, capacity),
            tok, lens,
        )
        rows.append(
            {
                "mesh": f"2x{n // 4}x2 (host x data x table)",
                "n_devices": n,
                "reads_per_sec": round(rps, 1),
                "efficiency": round(rps / (n * base2), 3),
            }
        )
        n *= 2
    return rows


def distributed_node_counts_2d(
    read_tokens: np.ndarray, lengths: np.ndarray, k: int, mesh,
    capacity: int = 1 << 16,
):
    """Host entry for the 2D mesh: returns the concatenated per-partition
    tables as one (hashes, counts) table plus the global occurrence total."""
    n_dev = mesh.devices.size
    R = read_tokens.shape[0]
    pad = (-R) % n_dev
    if pad:
        read_tokens = np.vstack(
            [read_tokens, np.zeros((pad, read_tokens.shape[1]), read_tokens.dtype)]
        )
        lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
    step = make_distributed_genemer_step_2d(mesh, k, capacity)
    sharding = jax.sharding.NamedSharding(mesh, P(("data", "table")))
    keys, counts, total = step(
        jax.device_put(read_tokens, sharding),
        jax.device_put(lengths, sharding),
    )
    keys = np.asarray(keys).reshape(-1)
    counts = np.asarray(counts).reshape(-1)
    mask = keys != 0
    return keys[mask], counts[mask], int(np.asarray(total).reshape(-1)[0])


def distributed_node_counts(read_tokens: np.ndarray, lengths: np.ndarray, k: int, mesh, capacity: int = 1 << 16):
    """Host entry: shard (R, L) reads over the mesh's data axis, run the
    collective count step, return the merged (hashes, counts) table."""
    n_dev = mesh.devices.size
    R = read_tokens.shape[0]
    pad = (-R) % n_dev
    if pad:
        read_tokens = np.vstack(
            [read_tokens, np.zeros((pad, read_tokens.shape[1]), read_tokens.dtype)]
        )
        lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
    step = make_distributed_genemer_step(mesh, k, capacity)
    sharding = jax.sharding.NamedSharding(mesh, P("data"))
    tokens_sharded = jax.device_put(read_tokens, sharding)
    lengths_sharded = jax.device_put(lengths, sharding)
    keys, counts, total = step(tokens_sharded, lengths_sharded)
    return np.asarray(keys), np.asarray(counts), int(np.asarray(total).reshape(-1)[0])


# --------------------------------------------------------- full graph build


def bounded_count_min(keys, weights, orderkeys, capacity: int):
    """bounded_count plus the MINIMUM orderkey per unique key.

    keys:      (N,) uint64 (0 = invalid)
    weights:   (N,) int32
    orderkeys: (N,) uint64 (global first-occurrence order; ties impossible)
    Returns (table_keys, table_counts, table_first): (capacity,) each; unused
    slots hold key 0 / count 0 / first UINT_MAX.
    """
    # lexsort by (key, orderkey): stable argsort of key over orderkey order
    perm1 = jnp.argsort(orderkeys)
    k1 = keys[perm1]
    perm2 = jnp.argsort(k1, stable=True)
    order = perm1[perm2]
    sk = keys[order]
    sw = weights[order]
    so = orderkeys[order]
    valid = sk != 0
    boundary = jnp.concatenate([valid[:1], (sk[1:] != sk[:-1]) & valid[1:]])
    run_id = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    run_id = jnp.where(valid, run_id, capacity)
    run_id = jnp.minimum(run_id, capacity)
    counts = jax.ops.segment_sum(
        jnp.where(valid, sw, 0), run_id, num_segments=capacity + 1
    )[:capacity]
    firsts = jax.ops.segment_min(
        jnp.where(valid, so, jnp.uint64(0xFFFFFFFFFFFFFFFF)),
        run_id,
        num_segments=capacity + 1,
    )[:capacity]
    table_keys = jnp.zeros((capacity + 1,), dtype=keys.dtype)
    table_keys = table_keys.at[jnp.where(boundary, run_id, capacity)].set(
        jnp.where(boundary, sk, 0)
    )[:capacity]
    return table_keys, counts.astype(jnp.int32), firsts


def _route_table(keys, counts, firsts, T: int, send_cap: int):
    """Route bounded-table entries to their hash-partition owner
    (dest = key % T) for an all_to_all over the "table" axis. Returns the
    three (T, send_cap) send buffers plus the number of real entries DROPPED
    by the per-destination capacity — exact-or-error: the host retries with
    a bigger send_cap when the psum'd drop count is nonzero."""
    n = keys.shape[0]
    dest = (keys % jnp.uint64(T)).astype(jnp.int32)
    dest = jnp.where(keys == 0, T, dest)  # padding -> dropped bucket
    order = jnp.argsort(dest, stable=True)
    sd = dest[order]
    sk = keys[order]
    sc = counts[order]
    sf = firsts[order]
    first_of_dest = jnp.searchsorted(sd, jnp.arange(T + 1, dtype=jnp.int32))
    idx = jnp.arange(n) - first_of_dest[jnp.clip(sd, 0, T)]
    ok = (sd < T) & (idx < send_cap)
    dropped = jnp.sum(((sd < T) & jnp.logical_not(ok)).astype(jnp.int32))
    row = jnp.where(ok, sd, 0)
    col = jnp.where(ok, idx, send_cap)
    send_k = (
        jnp.zeros((T, send_cap + 1), dtype=jnp.uint64)
        .at[row, col].set(jnp.where(ok, sk, 0))[:, :send_cap]
    )
    send_c = (
        jnp.zeros((T, send_cap + 1), dtype=jnp.int32)
        .at[row, col].set(jnp.where(ok, sc, 0))[:, :send_cap]
    )
    send_f = (
        jnp.zeros((T, send_cap + 1), dtype=jnp.uint64)
        .at[row, col].set(jnp.where(ok, sf, 0))[:, :send_cap]
    )
    return send_k, send_c, send_f, dropped


def make_distributed_graph_step(
    mesh, k: int, node_cap: int, edge_cap: int, route_cap: int = 0
):
    """Full-graph distributed build step, generalized over mesh families.

    Each device windows its read shard, forms node occurrences
    (key, orderkey) and edge records (canonical edge key, orderkey for the
    interleaved fwd/rc-companion stream), reduces them to bounded local
    tables, then merges across the mesh. The merged tables carry everything
    the reference graph needs beyond raw counts: per-node and per-edge
    COVERAGE plus the GLOBAL first-occurrence order key, from which the host
    reconstructs canonical tokens, edge endpoints/orientations and the
    reference's read-major insertion order (construct_graph.py:31-102
    semantics). The per-shard window streams returned alongside ARE the
    read->node incidence.

    Mesh families (reads always shard data-parallel over EVERY axis):
    - ("data",): local tables all_gathered + re-reduced, replicated.
    - ("data", "table"): local tables hash-routed to their table-partition
      owner (all_to_all over "table"), then the data-axis partials merge via
      all_gather + re-reduce — each table column holds the global table for
      its hash partition.
    - ("host", "data", "table"): as 2D inside each host, then the
      per-host deduplicated partition tables merge across the "host"
      (network) axis — hierarchical: only deduplicated tables cross the slow axis,
      the collective form of the reference's shard merge
      (amira/graph_utils.py:17-102).

    A psum'd overflow count of entries dropped by routing capacity is
    returned; nonzero means the host must retry with a larger route_cap
    (exact-or-error, never silent).

    orderkey convention: node occ -> global_window_position; edge record ->
    2*global_pair_position + slot (0 fwd, 1 rc companion) — identical to the
    single-host lazy tables (amira_tpu/graph.py)."""
    shard_map = jax.shard_map
    axes = tuple(mesh.axis_names)
    has_table = "table" in axes
    has_host = "host" in axes
    T = mesh.shape["table"] if has_table else 1
    all_axes = axes  # reads shard over every axis

    def merge_tables(lk, lc, lf, cap):
        """Local bounded tables -> globally merged tables (+ dropped count)."""
        dropped = jnp.int32(0)
        if has_table:
            cap_n = route_cap if route_cap else max(cap // T * 2, 256)
            sk, sc, sf, drop = _route_table(lk, lc, lf, T, cap_n)
            dropped = dropped + drop
            rk = jax.lax.all_to_all(sk, "table", 0, 0, tiled=False).reshape(-1)
            rc = jax.lax.all_to_all(sc, "table", 0, 0, tiled=False).reshape(-1)
            rf = jax.lax.all_to_all(sf, "table", 0, 0, tiled=False).reshape(-1)
            lk, lc, lf = bounded_count_min(rk, rc, rf, cap)
        g_k = jax.lax.all_gather(lk, "data").reshape(-1)
        g_c = jax.lax.all_gather(lc, "data").reshape(-1)
        g_f = jax.lax.all_gather(lf, "data").reshape(-1)
        mk, mc, mf = bounded_count_min(g_k, g_c, g_f, cap)
        if has_host:
            h_k = jax.lax.all_gather(mk, "host").reshape(-1)
            h_c = jax.lax.all_gather(mc, "host").reshape(-1)
            h_f = jax.lax.all_gather(mf, "host").reshape(-1)
            mk, mc, mf = bounded_count_min(h_k, h_c, h_f, cap)
        return mk, mc, mf, dropped

    def shard_step(tokens, lengths, win_base, pair_base):
        win = genemer_windows(tokens, lengths, k)
        nh_raw, nd, valid = win["node_hash"], win["direction"], win["valid"]
        R, W = nh_raw.shape
        nh = jnp.where(valid, nh_raw, 0)
        # win_base carries each row's GLOBAL valid-window offset already
        widx = jnp.arange(W, dtype=jnp.uint64)[None, :]
        occ_ok = win_base[:, None] + widx
        node_keys, node_covs, node_first = bounded_count_min(
            nh.reshape(-1),
            jnp.ones(nh.size, jnp.int32),
            occ_ok.reshape(-1),
            node_cap,
        )
        m_nk, m_nc, m_nf, drop_n = merge_tables(
            node_keys, node_covs, node_first, node_cap
        )

        if W >= 2:
            src_h, tgt_h = nh_raw[:, :-1], nh_raw[:, 1:]
            src_d, tgt_d = nd[:, :-1], nd[:, 1:]
            ev = valid[:, :-1] & valid[:, 1:]
            e1 = jnp.where(ev, edge_key(src_h, src_d, tgt_h, tgt_d), 0)
            e2 = jnp.where(ev, edge_key(tgt_h, -tgt_d, src_h, -src_d), 0)
            pidx = jnp.arange(W - 1, dtype=jnp.uint64)[None, :]
            pair_pos = pair_base[:, None] + pidx
            ek = jnp.stack([e1, e2], axis=-1).reshape(-1)
            eok = jnp.stack(
                [pair_pos * jnp.uint64(2), pair_pos * jnp.uint64(2) + jnp.uint64(1)],
                axis=-1,
            ).reshape(-1)
        else:
            ek = jnp.zeros((2,), jnp.uint64)
            eok = jnp.zeros((2,), jnp.uint64)
        edge_keys, edge_covs, edge_first = bounded_count_min(
            ek, jnp.ones(ek.shape[0], jnp.int32), eok, edge_cap
        )
        m_ek, m_ec, m_ef, drop_e = merge_tables(
            edge_keys, edge_covs, edge_first, edge_cap
        )

        overflow = drop_n + drop_e
        if has_table:
            overflow = jax.lax.psum(overflow, "table")
        overflow = jax.lax.psum(overflow, "data")
        if has_host:
            overflow = jax.lax.psum(overflow, "host")

        table_shape = (
            (lambda a: a[None, :]) if has_table else (lambda a: a)
        )
        return (
            table_shape(m_nk), table_shape(m_nc), table_shape(m_nf),
            table_shape(m_ek), table_shape(m_ec), table_shape(m_ef),
            jnp.where(valid, nh_raw, 0),
            jnp.where(valid, nd, 0).astype(jnp.int8),
            overflow,
        )

    table_spec = P("table") if has_table else P()
    step = shard_map(
        shard_step,
        mesh=mesh,
        in_specs=(P(all_axes), P(all_axes), P(all_axes), P(all_axes)),
        out_specs=(
            table_spec, table_spec, table_spec,
            table_spec, table_spec, table_spec,
            P(all_axes), P(all_axes), P(),
        ),
        check_vma=False,
    )
    return jax.jit(step)


def _pow2(n: int, minimum: int = 1 << 10) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def distributed_graph_build(
    read_dict, k: int, mesh, vocab=None, gene_positions=None,
    node_cap: int | None = None, edge_cap: int | None = None,
):
    """Build a GeneMerGraph by sharding reads data-parallel over EVERY mesh
    axis — ("data",), ("data", "table") or ("host", "data", "table") — and
    collective-merging the full node/edge/incidence tables. The result is
    IDENTICAL (node hashes, coverages, read lists, edge endpoints, insertion
    order) to a single-device GeneMerGraph of the same read dict — verified
    by tests/test_parallel.py and __graft_entry__.dryrun_multichip.

    Table capacities default to pow2(total_occurrences/2) sized FROM the
    occurrence stream and retry with doubling on overflow, up to
    pow2(total_occurrences), which cannot overflow (#unique <= #occurrences)
    — so builds of any size succeed (the reference's 500k-read ceiling,
    __main__.py:136-142, included)."""
    from amira_tpu.graph import GeneMerGraph
    from amira_tpu.vocab import GeneVocab, pack_reads

    if vocab is None:
        vocab = GeneVocab()
    n_dev = mesh.devices.size
    graph = GeneMerGraph.__new__(GeneMerGraph)
    graph._reads = dict(read_dict)
    graph._kmerSize = int(k)
    graph._genePositions = gene_positions
    graph._minNodeCoverage = 1
    graph._minEdgeCoverage = 1
    graph.vocab = vocab
    graph._cache = None
    graph._nodes_d = {}
    graph._edges_d = {}
    graph._readNodes_d = {}
    graph._readNodeDirections_d = {}
    graph._readNodePositions_d = {}
    graph._shortReads = {}
    graph._readsToCorrect = set()
    graph._lazy = None

    kept_ids = []
    tok_list = []
    for rid, genes in read_dict.items():
        toks = vocab.encode_reads_batch([genes])[0]
        if len(toks) < k:
            graph._shortReads[rid] = genes
            continue
        kept_ids.append(rid)
        tok_list.append(toks)
    if not kept_ids:
        return graph

    lens = np.fromiter((len(t) for t in tok_list), np.int64, len(tok_list))
    L = int(lens.max())
    tokens, lengths = pack_reads(tok_list, pad_to=L)
    R = tokens.shape[0]
    pad = (-R) % n_dev
    if pad:
        tokens = np.vstack([tokens, np.zeros((pad, L), tokens.dtype)])
        lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
    wlens = np.maximum(lens - (k - 1), 0)
    offs = np.zeros(len(kept_ids) + 1, np.int64)
    np.cumsum(wlens, out=offs[1:])
    plens = np.maximum(lens - k, 0)
    poffs = np.zeros(len(kept_ids) + 1, np.int64)
    np.cumsum(plens, out=poffs[1:])
    win_base = np.concatenate(
        [offs[:-1], np.full(pad, offs[-1], np.int64)]
    ).astype(np.uint64)
    pair_base = np.concatenate(
        [poffs[:-1], np.full(pad, poffs[-1], np.int64)]
    ).astype(np.uint64)

    axes = tuple(mesh.axis_names)
    has_table = "table" in axes
    T = mesh.shape["table"] if has_table else 1
    total_occ = int(offs[-1])
    total_edge_records = 2 * int(poffs[-1])
    # caps sized from the occurrence stream; #unique <= #occurrences bounds
    # the retry ladder, so overflow always terminates in success
    ncap = node_cap or _pow2(total_occ // 2 + 2)
    ecap = edge_cap or _pow2(total_edge_records // 2 + 2)
    ncap_max = max(ncap, _pow2(total_occ + 2))
    ecap_max = max(ecap, _pow2(total_edge_records + 2))
    route_cap = 0  # 0 = auto (cap // T * 2); doubled on routing overflow
    sharding = jax.sharding.NamedSharding(mesh, P(axes))
    dev_in = (
        jax.device_put(tokens, sharding),
        jax.device_put(lengths, sharding),
        jax.device_put(win_base, sharding),
        jax.device_put(pair_base, sharding),
    )

    def _merge_partitions(tab_k, tab_c, tab_f, cap):
        """Host: concatenate hash partitions (disjoint by key % T) into the
        single key-sorted table _finish_from_distributed_tables expects; the
        trailing zero row keeps its overflow check meaningful."""
        keys = tab_k.reshape(-1)
        mask = keys != 0
        keys = keys[mask]
        cnts = tab_c.reshape(-1)[mask]
        fsts = tab_f.reshape(-1)[mask]
        order = np.argsort(keys)
        one_zero = np.zeros(1, dtype=tab_k.dtype)
        return (
            np.concatenate([keys[order], one_zero]),
            np.concatenate([cnts[order], np.zeros(1, tab_c.dtype)]),
            np.concatenate([fsts[order], np.zeros(1, tab_f.dtype)]),
        )

    while True:
        step = make_distributed_graph_step(mesh, k, ncap, ecap, route_cap)
        out = step(*dev_in)
        (m_nk, m_nc, m_nf, m_ek, m_ec, m_ef, wh_full, wd_full, overflow) = (
            np.asarray(x) for x in out
        )
        if int(overflow.reshape(-1)[0]) > 0:
            # routing capacity dropped entries: exact-or-error, retry bigger
            base = route_cap or max(ncap // T * 2, 256)
            route_cap = base * 2
            continue

        def _any_full(tab):
            rows = tab.reshape(-1, tab.shape[-1])
            return bool(((rows != 0).sum(axis=1) >= rows.shape[1]).any())

        node_full = _any_full(m_nk)
        edge_full = _any_full(m_ek)
        if node_full and ncap < ncap_max:
            ncap = min(ncap * 2, ncap_max)
            continue
        if edge_full and ecap < ecap_max:
            ecap = min(ecap * 2, ecap_max)
            continue
        break

    if has_table:
        m_nk, m_nc, m_nf = _merge_partitions(m_nk, m_nc, m_nf, ncap)
        m_ek, m_ec, m_ef = _merge_partitions(m_ek, m_ec, m_ef, ecap)

    graph._finish_from_distributed_tables(
        kept_ids, tok_list, lens, offs,
        m_nk, m_nc, m_nf, m_ek, m_ec, m_ef,
        wh_full[: len(kept_ids)], wd_full[: len(kept_ids)],
    )
    return graph


# ---------------------------------------------------- distributed DNA k-mers


def make_distributed_kmer_step(mesh, k: int, chunk: int):
    """Jitted multi-chip dense canonical DNA k-mer count step (the
    distributed jellyfish replacement, result_utils.py:1050-1141 at scale).

    Each device unpacks its 2-bit-packed code shard, forms canonical
    window codes and scatter-adds them into a local dense (4^k + 1)-bin
    table; ONE psum_scatter over the `kdata` axis then leaves every device
    holding its bin-slice of the GLOBAL table — per-device table memory
    scales down with mesh size (a 4 GB k=15 table becomes 512 MB per device
    on 8 devices). `chunk` is the per-device code count.
    """
    from amira_tpu.ops.kmer import _SENTINEL  # noqa: F401 (doc anchor)

    shard_map = jax.shard_map
    D = mesh.devices.size
    T = 4**k + 1
    Tp = ((T + D - 1) // D) * D  # bin count padded to the mesh size

    def shard_step(packed_words, bad_bytes):
        packed_words = packed_words.reshape(-1)
        bad_bytes = bad_bytes.reshape(-1)
        shifts = jnp.arange(16, dtype=jnp.uint32) * 2
        codes = ((packed_words[:, None] >> shifts[None, :]) & 3).reshape(-1)
        bshift = jnp.arange(8, dtype=jnp.uint8)
        bad = (((bad_bytes[:, None] >> bshift[None, :]) & 1) != 0).reshape(-1)
        n = codes.shape[0] - k + 1
        fwd = jnp.zeros(n, dtype=jnp.uint32)
        rc = jnp.zeros(n, dtype=jnp.uint32)
        valid = jnp.ones(n, dtype=bool)
        for j in range(k):
            bj = codes[j : j + n]
            valid = valid & jnp.logical_not(bad[j : j + n])
            fwd = (fwd << 2) | bj
            rc = rc | (((3 - bj) & 3) << (2 * j))
        canon = jnp.minimum(fwd, rc)
        idx = jnp.where(valid, canon, jnp.uint32(4**k))
        local = jnp.zeros(Tp, jnp.uint32).at[idx].add(jnp.uint32(1))
        # bin-sharded global sum: each device keeps bins
        # [rank*Tp/D, (rank+1)*Tp/D) of the summed table
        return jax.lax.psum_scatter(
            local, "kdata", scatter_dimension=0, tiled=True
        )

    step = shard_map(
        shard_step,
        mesh=mesh,
        in_specs=(P("kdata"), P("kdata")),
        out_specs=P("kdata"),
        check_vma=False,
    )
    return jax.jit(step)


def distributed_kmer_count(codes, k: int, devices=None):
    """Count canonical k-mers of a sentinel-separated code stream over all
    local devices. Splits the stream at sequence boundaries into one chunk
    per device (padding with invalid positions), runs the shard_map step,
    and returns the global dense table as a host array of 4^k + 1 bins
    (the padded tail bins are dropped; slot 4^k holds invalid windows).

    At real multi-chip scale callers keep the bin-sharded device output;
    materializing the full table here serves the single-host test and
    dryrun paths."""
    import numpy as np

    from amira_tpu.ops.kmer import _SENTINEL, _pack_codes_2bit

    if devices is None:
        devices = jax.devices()
    D = len(devices)
    mesh = jax.sharding.Mesh(np.array(devices), ("kdata",))
    n = len(codes)
    # Split points at sequence boundaries, one chunk per device. When a
    # sequence is longer than the per-device span, no separator exists to
    # back up to; then the next chunk overlaps the cut by k-1 codes so the
    # boundary-spanning windows count exactly once (mirrors
    # KmerCounter._from_codes_dense) — a plain cut dropped k-1 windows per
    # mid-sequence boundary.
    starts, ends = [0], []
    for d in range(1, D):
        cut = min(n, (n * d) // D)
        cut = max(cut, starts[-1])
        next_start = cut
        if 0 < cut < n:
            seps = np.nonzero(codes[starts[-1] : cut] == _SENTINEL)[0]
            if len(seps):
                cut = starts[-1] + int(seps[-1]) + 1
                next_start = cut
            elif codes[cut - 1] != _SENTINEL:
                # mid-sequence cut: overlap by k-1 (clamped so a chunk
                # shorter than k — which contributes no windows — cannot
                # double-count)
                next_start = max(cut - (k - 1), starts[-1])
        ends.append(cut)
        starts.append(next_start)
    ends.append(n)
    chunks = [codes[starts[d] : ends[d]] for d in range(D)]
    chunk_len = max(max((len(c) for c in chunks), default=1), k)
    chunk_len = ((chunk_len + 15) // 16 * 16) + 16
    words_rows, bad_rows = [], []
    for c in chunks:
        if len(c) < chunk_len:
            c = np.concatenate(
                [c, np.full(chunk_len - len(c), _SENTINEL, np.uint8)]
            )
        w, b = _pack_codes_2bit(c)
        words_rows.append(w)
        bad_rows.append(b)
    words = np.stack(words_rows)
    bad = np.stack(bad_rows)
    step = make_distributed_kmer_step(mesh, k, chunk_len)
    out = np.asarray(step(words, bad))
    return out[: 4**k + 1]

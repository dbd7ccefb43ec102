"""Device-side graph table assembly.

The gene-mer graph's node/edge/coverage/read-incidence tables are grouped
sort/unique/segment computations over ~10^6 window occurrences. On a weak
host these gathers dominate the build, so they run on the accelerator: the
per-bucket window kernels leave their outputs on device, the flattened
occurrence streams are concatenated there, and one jitted assembly pass
produces hash-grouped occurrence tables, unique (node, read) pair tables and
edge record tables. Only boundary-masked arrays cross back to the host,
which materializes the Python-level Node/Edge wrappers from contiguous
slices.

Ordering: every occurrence carries an order key (read_index, window, 0/1 for
edge fwd/rev) matching the reference's read-major insertion order
(construct_graph.py:45-100). Streams are stable-sorted by order key and then
by hash, so the first slot of every hash run IS the first occurrence and
boundary slots carry its direction/tokens/endpoints directly.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from amira_tpu.ops.hashing import edge_key, gene_hash, genemer_windows, splitmix64

UINT_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
_WBITS = 22  # window index fits in 21 bits; bit 0 is the edge fwd/rev slot


@partial(jax.jit, static_argnames=("k",))
def bucket_occurrences(tokens, lengths, sel, k: int):
    """Flattened occurrence + edge-record streams for one length bucket.

    tokens: (R, L) int32 padded signed gene tokens
    lengths: (R,)
    sel:    (R,) int32 global read index per row (-1 for padding rows)
    Returns occurrence arrays of length R*W and edge arrays of length
    2*R*(W-1); invalid slots carry key UINT_MAX and order key INT64_MAX.
    """
    win = genemer_windows(tokens, lengths, k)
    nh, nd, valid = win["node_hash"], win["direction"], win["valid"]
    R, W = nh.shape
    rows = jax.lax.broadcasted_iota(jnp.int32, (R, W), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (R, W), 1)
    read_idx = sel[rows]
    okey = (
        read_idx.astype(jnp.int64) << _WBITS
    ) | (cols.astype(jnp.int64) << 1)
    BIGKEY = jnp.int64(2**62)
    occ_hash = jnp.where(valid, nh, UINT_MAX).reshape(-1)
    occ_dir = jnp.where(valid, nd, 0).astype(jnp.int8).reshape(-1)
    occ_read = jnp.where(valid, read_idx, -1).reshape(-1)
    occ_key = jnp.where(valid, okey, BIGKEY).reshape(-1)

    if W >= 2:
        src_h, tgt_h = nh[:, :-1], nh[:, 1:]
        src_d = nd[:, :-1].astype(jnp.int8)
        tgt_d = nd[:, 1:].astype(jnp.int8)
        ev = valid[:, :-1] & valid[:, 1:]
        e1 = jnp.where(ev, edge_key(src_h, src_d, tgt_h, tgt_d), UINT_MAX)
        e2 = jnp.where(ev, edge_key(tgt_h, -tgt_d, src_h, -src_d), UINT_MAX)
        ekey1 = jnp.where(ev, okey[:, :-1], BIGKEY)  # fwd slot (bit0 = 0)
        ekey2 = jnp.where(ev, okey[:, :-1] | 1, BIGKEY)  # rev slot

        def interleave(a, b):
            return jnp.stack([a.reshape(-1), b.reshape(-1)], -1).reshape(-1)

        ekeys = interleave(e1, e2)
        eokey = interleave(ekey1, ekey2)
    else:
        ekeys = jnp.full((2,), UINT_MAX, jnp.uint64)
        eokey = jnp.full((2,), BIGKEY, jnp.int64)
    return occ_hash, occ_dir, occ_read, occ_key, ekeys, eokey


@partial(jax.jit, static_argnames=("k",))
def pack_windows_edges(tokens, lengths, k: int):
    """Per-read window hashes/directions plus interleaved canonical edge keys
    for one length bucket, packed into a single 1-D uint32 buffer (one
    device-to-host copy per bucket):

      [h_lo (R*W) | h_hi (R*W) | dir+1 (R*W) | ek_lo (R*2(W-1)) | ek_hi (…)]

    Feeds the incremental build cache (amira_tpu/graph_cache.py): the host
    slices each row to the read's true window count, so padded slots never
    need masking.
    """
    win = genemer_windows(tokens, lengths, k)
    nh, nd = win["node_hash"], win["direction"]
    R, W = nh.shape
    lo, hi = split_u64(nh)
    d = (nd.astype(jnp.int32) + 1).astype(jnp.uint32)
    parts = [lo.reshape(-1), hi.reshape(-1), d.reshape(-1)]
    if W >= 2:
        src_h, tgt_h = nh[:, :-1], nh[:, 1:]
        src_d = nd[:, :-1].astype(jnp.int8)
        tgt_d = nd[:, 1:].astype(jnp.int8)
        e1 = edge_key(src_h, src_d, tgt_h, tgt_d)
        e2 = edge_key(tgt_h, -tgt_d, src_h, -src_d)
        ek = jnp.stack([e1, e2], -1).reshape(R, -1)
        eklo, ekhi = split_u64(ek)
        parts += [eklo.reshape(-1), ekhi.reshape(-1)]
    return jnp.concatenate(parts)


@partial(jax.jit, static_argnames=("n_reads",))
def assemble_node_tables(occ_hash, occ_read, occ_key, n_reads: int):
    """Hash-grouped occurrence tables + unique (node, read) pair tables.

    Outputs (all length N, boundary-masked):
      sh:        hash per slot (sorted by (hash, order key))
      boundary:  True at the first slot of each hash run
      run_key:   order key of the slot (at boundaries: the first occurrence,
                 encoding (read_index << 22 | window << 1))
      run_cov:   run coverage broadcast to every slot
      pboundary / pair_run / pair_read: unique (node-run, read) pairs, sorted
                 by (run, read) — read order == first-occurrence order.
    """
    N = occ_hash.shape[0]
    # stable order-key sort, then stable hash sort: within each hash run,
    # slots are in first-occurrence order
    o1 = jnp.argsort(occ_key, stable=True)
    o2 = jnp.argsort(occ_hash[o1], stable=True)
    perm = o1[o2]
    sh = occ_hash[perm]
    valid = sh != UINT_MAX
    boundary = valid & jnp.concatenate(
        [jnp.ones((1,), bool), sh[1:] != sh[:-1]]
    )
    run_id = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    seg = jnp.where(valid, run_id, N).astype(jnp.int32)
    cov = jax.ops.segment_sum(valid.astype(jnp.int32), seg, num_segments=N + 1)
    run_cov = cov[seg]
    run_key = occ_key[perm]
    # unique (node, read) pairs: two native stable sorts (read then run) give
    # (run, read) order while keeping first-occurrence order within pairs
    HUGE = jnp.int32(0x7FFFFFFF)
    sread = occ_read[perm]
    read32 = jnp.where(valid, sread.astype(jnp.int32), HUGE)
    run32 = jnp.where(valid, run_id, HUGE)
    po = jnp.argsort(read32, stable=True)
    po = po[jnp.argsort(run32[po], stable=True)]
    prun_s = run32[po]
    pread_s = read32[po]
    pvalid = prun_s != HUGE
    pboundary = pvalid & jnp.concatenate(
        [
            jnp.ones((1,), bool),
            (prun_s[1:] != prun_s[:-1]) | (pread_s[1:] != pread_s[:-1]),
        ]
    )
    pair_run = jnp.where(pvalid, prun_s, -1)
    pair_read = jnp.where(pvalid, pread_s, -1)
    return sh, boundary, run_key, run_cov, pboundary, pair_run, pair_read


@jax.jit
def _count_true(mask):
    return jnp.sum(mask.astype(jnp.int32))


@jax.jit
def count_true3(m1, m2, m3):
    """Three boundary counts in one device round trip."""
    return jnp.stack(
        [
            jnp.sum(m1.astype(jnp.int32)),
            jnp.sum(m2.astype(jnp.int32)),
            jnp.sum(m3.astype(jnp.int32)),
        ]
    )


@partial(jax.jit, static_argnames=("Cn", "Cp", "Ce"))
def compact_all(
    sh, boundary, run_key, run_cov,
    pboundary, pair_run, pair_read,
    esk, eboundary, ecov, eokey,
    Cn: int, Cp: int, Ce: int,
):
    """All three compactions concatenated into ONE uint32 buffer, so the
    whole table set is copied to the host in a single transfer.

    Layout: [node h_lo|h_hi|k_lo|k_hi|cov (5*Cn)] [pair run|read (2*Cp)]
            [edge k_lo|k_hi|cov|o_lo|o_hi (5*Ce)]
    """
    n = compact_node_tables(sh, boundary, run_key, run_cov, Cn)
    p = compact_pair_tables(pboundary, pair_run, pair_read, Cp)
    e = compact_edge_tables(esk, eboundary, ecov, eokey, Ce)
    return jnp.concatenate(list(n) + list(p) + list(e))


@jax.jit
def pack_bucket(occ_hash, occ_dir):
    """Per-bucket read-window arrays as one uint32 buffer:
    [hash_lo | hash_hi | dir+1]."""
    lo, hi = split_u64(occ_hash)
    d = (occ_dir.astype(jnp.int32) + 1).astype(jnp.uint32)
    return jnp.concatenate([lo, hi, d])


@jax.jit
def split_u64(x):
    """uint64 -> (lo, hi) uint32 pair, so 64-bit keys can share one packed
    uint32 buffer with the 32-bit columns (join_u64 undoes it)."""
    xu = x.astype(jnp.uint64)
    return (
        (xu & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32),
        (xu >> jnp.uint64(32)).astype(jnp.uint32),
    )


def join_u64(lo, hi):
    return lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))


@partial(jax.jit, static_argnames=("C",))
def compact_node_tables(sh, boundary, run_key, run_cov, C: int):
    """Scatter boundary slots into a (C,) compact table; everything returned
    as uint32 so compact_all packs it into one buffer."""
    run_id = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    idx = jnp.where(boundary, run_id, C)
    def scat(v, dtype):
        out = jnp.zeros((C + 1,), dtype)
        return out.at[idx].set(jnp.where(boundary, v, 0).astype(dtype))[:C]
    h_lo, h_hi = split_u64(sh)
    k_lo, k_hi = split_u64(run_key.astype(jnp.uint64))
    return (
        scat(h_lo, jnp.uint32), scat(h_hi, jnp.uint32),
        scat(k_lo, jnp.uint32), scat(k_hi, jnp.uint32),
        scat(run_cov, jnp.uint32),
    )


@partial(jax.jit, static_argnames=("C",))
def compact_pair_tables(pboundary, pair_run, pair_read, C: int):
    run_id = jnp.cumsum(pboundary.astype(jnp.int32)) - 1
    idx = jnp.where(pboundary, run_id, C)
    def scat(v):
        out = jnp.zeros((C + 1,), jnp.uint32)
        return out.at[idx].set(
            jnp.where(pboundary, v, 0).astype(jnp.uint32)
        )[:C]
    return scat(pair_run), scat(pair_read)


@partial(jax.jit, static_argnames=("C",))
def compact_edge_tables(sk, boundary, cov, eokey, C: int):
    run_id = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    idx = jnp.where(boundary, run_id, C)
    def scat(v, dtype):
        out = jnp.zeros((C + 1,), dtype)
        return out.at[idx].set(jnp.where(boundary, v, 0).astype(dtype))[:C]
    k_lo, k_hi = split_u64(sk)
    o_lo, o_hi = split_u64(eokey.astype(jnp.uint64))
    return (
        scat(k_lo, jnp.uint32), scat(k_hi, jnp.uint32),
        scat(cov, jnp.uint32),
        scat(o_lo, jnp.uint32), scat(o_hi, jnp.uint32),
    )


@jax.jit
def assemble_edge_tables(ekeys, eokey):
    """Edge-key-grouped tables sorted by (key, order key): boundary slots
    carry the unique key, its coverage, and first-occurrence order key (from
    which the host reconstructs the endpoint record)."""
    N = ekeys.shape[0]
    o1 = jnp.argsort(eokey, stable=True)
    o2 = jnp.argsort(ekeys[o1], stable=True)
    perm = o1[o2]
    sk = ekeys[perm]
    valid = sk != UINT_MAX
    boundary = valid & jnp.concatenate(
        [jnp.ones((1,), bool), sk[1:] != sk[:-1]]
    )
    run_id = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    seg = jnp.where(valid, run_id, N).astype(jnp.int32)
    cov = jax.ops.segment_sum(valid.astype(jnp.int32), seg, num_segments=N + 1)[
        seg
    ]
    return sk, boundary, cov, eokey[perm]


@partial(jax.jit, static_argnames=("k",))
def pack_flat_windows(tok_flat, k: int):
    """Canonical window hash/direction at EVERY position of a flat
    concatenated token stream, packed [h_lo | h_hi | dir+1] (uint32).

    One dispatch per build instead of one per length bucket: the host
    concatenates all reads into a single 1-D stream and slices each read's
    valid windows out afterwards; windows that span a read boundary or the
    padded tail are simply never read. Edge keys are NOT computed on device —
    the host derives them from the window stream (halves the device-to-host
    copy). Hash values are bit-identical to genemer_windows (same
    canonicalization and splitmix chain over the flat layout)."""
    h = gene_hash(tok_flat)  # (N,) int64 signed
    fwd = jnp.stack([jnp.roll(h, -j) for j in range(k)], axis=-1)  # (N, k)
    rc = -fwd[..., ::-1]
    diff = fwd != rc
    first = jnp.argmax(diff, axis=-1)
    fwd_at = jnp.take_along_axis(fwd, first[..., None], axis=-1)[..., 0]
    rc_at = jnp.take_along_axis(rc, first[..., None], axis=-1)[..., 0]
    fwd_is_canon = fwd_at <= rc_at
    canon = jnp.where(fwd_is_canon[..., None], fwd, rc)
    acc = jnp.full(canon.shape[:-1], jnp.uint64(k), dtype=jnp.uint64)
    for j in range(k):
        acc = splitmix64(acc ^ canon[..., j].astype(jnp.uint64))
    lo, hi = split_u64(acc)
    d = (jnp.where(fwd_is_canon, 1, -1) + 1).astype(jnp.uint32)
    return jnp.concatenate([lo, hi, d])

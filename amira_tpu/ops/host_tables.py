"""Host (NumPy) mirror of the per-read window/edge-key kernels.

Small batches are the common case inside the cleaning loop: each iteration
re-windows only the few percent of reads whose annotation changed
(amira_tpu/graph_cache.py), and such a batch is cheaper to window on the
host than to pad, dispatch and copy back. This module reproduces
ops/hashing.genemer_windows + ops/graph_tables.pack_windows_edges
bit-for-bit in NumPy (fuzz-verified in tests/test_host_tables.py);
amira_tpu/graph.py routes a miss batch here whenever its total gene count
is below HOST_BATCH_GENE_LIMIT.
"""

from __future__ import annotations

import numpy as np

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)

# route miss batches with fewer total genes than this to the host path;
# either path gives identical windows, so this only moves time between
# host and device (the value is not yet tuned on a GPU: ROADMAP)
HOST_BATCH_GENE_LIMIT = 200_000

def _splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over uint64 arrays (== ops.hashing.splitmix64)."""
    with np.errstate(over="ignore"):
        x = x * _GOLDEN + np.uint64(1)
        x = (x ^ (x >> np.uint64(30))) * _MIX1
        x = (x ^ (x >> np.uint64(27))) * _MIX2
        return x ^ (x >> np.uint64(31))


def _gene_hash(tokens: np.ndarray) -> np.ndarray:
    """Signed 63-bit hash per signed gene token (== ops.hashing.gene_hash)."""
    ids = np.abs(tokens).astype(np.uint64)
    h = (_splitmix64(ids) >> np.uint64(1)).astype(np.int64)
    return np.sign(tokens).astype(np.int64) * h


def _edge_key(src_h, src_d, tgt_h, tgt_d):
    """Canonical edge identity (== ops.hashing.edge_key)."""
    with np.errstate(over="ignore"):
        a = src_h.astype(np.int64) * src_d.astype(np.int64)
        b = tgt_h.astype(np.int64) * tgt_d.astype(np.int64)
        na, nb = -a, -b
        take_neg = (na < a) | ((na == a) & (nb < b))
        ca = np.where(take_neg, na, a)
        cb = np.where(take_neg, nb, b)
        acc = _splitmix64(np.uint64(2) ^ ca.astype(np.uint64))
        return _splitmix64(acc ^ cb.astype(np.uint64))


def host_windows_edges(tok_list: list[np.ndarray], k: int):
    """Per-read canonical window hashes, directions, and interleaved edge
    keys for a batch of tokenized reads, computed on the host.

    Returns a list of (wh uint64 (W,), wd int8 (W,), ek uint64 (2*(W-1),))
    matching exactly what graph.GeneMerGraph._compute_cache_misses derives
    from the device kernel's packed buffer. Every read must have >= k genes.
    """
    R = len(tok_list)
    L = max(len(t) for t in tok_list)
    tokens = np.zeros((R, L), np.int32)
    for i, t in enumerate(tok_list):
        tokens[i, : len(t)] = t
    h = _gene_hash(tokens)  # (R, L) int64 signed
    W = L - k + 1
    fwd = np.stack([h[:, j : j + W] for j in range(k)], axis=-1)  # (R, W, k)
    rc = -fwd[..., ::-1]
    diff = fwd != rc
    first = np.argmax(diff, axis=-1)
    fwd_at = np.take_along_axis(fwd, first[..., None], axis=-1)[..., 0]
    rc_at = np.take_along_axis(rc, first[..., None], axis=-1)[..., 0]
    fwd_is_canon = fwd_at <= rc_at
    canon = np.where(fwd_is_canon[..., None], fwd, rc)
    acc = np.full(canon.shape[:-1], np.uint64(k), dtype=np.uint64)
    for j in range(k):
        acc = _splitmix64(acc ^ canon[..., j].astype(np.uint64))
    nh = acc  # (R, W) uint64
    nd = np.where(fwd_is_canon, 1, -1).astype(np.int8)
    if W >= 2:
        src_h, tgt_h = nh[:, :-1], nh[:, 1:]
        src_d, tgt_d = nd[:, :-1], nd[:, 1:]
        e1 = _edge_key(src_h, src_d, tgt_h, tgt_d)
        e2 = _edge_key(tgt_h, -tgt_d.astype(np.int8), src_h, -src_d.astype(np.int8))
        ek = np.stack([e1, e2], axis=-1).reshape(R, -1)  # (R, 2*(W-1))
    else:
        ek = np.zeros((R, 0), np.uint64)
    out = []
    for i, t in enumerate(tok_list):
        Wt = len(t) - (k - 1)
        out.append(
            (
                np.ascontiguousarray(nh[i, :Wt]),
                np.ascontiguousarray(nd[i, :Wt]),
                np.ascontiguousarray(ek[i, : 2 * (Wt - 1)]),
            )
        )
    return out

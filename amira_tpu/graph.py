"""The gene-space de Bruijn graph ("gene-mer graph"), tensor-first.

Re-designs amira/construct_graph.py's dict-of-objects GeneMerGraph: gene-mer
enumeration, canonicalization and hashing run as one batched JAX computation
(amira_tpu/ops/hashing.py); node/edge/coverage tables are then assembled with
vectorized numpy group-bys instead of per-object Python dispatch. The
resulting graph keeps the reference's exact identity and coverage semantics
(construct_graph.py:31-102) so every downstream algorithm (correction, bubble
popping, path clustering) sees an equivalent structure.

Mutation (node/edge removal, filtering) and the irregular traversals operate
on compact host-side tables; they are a tiny fraction of runtime next to the
dozens of full rebuilds the pipeline performs, which are the device-side hot
path.
"""

from __future__ import annotations

import numpy as np

from amira_tpu.ops.hashing import edge_key, genemer_windows
from amira_tpu.vocab import GeneVocab, pack_reads, reverse_tokens

import jax
import jax.numpy as jnp
from functools import partial


@partial(jax.jit, static_argnames=("k",))
def _graph_kernel(tokens, lengths, k):
    """Device-side gene-mer + edge-record enumeration for a padded read batch.

    Returns per-window node hashes/directions/validity and, for each adjacent
    window pair, the two canonical edge keys (fwd edge and its rc companion,
    mirroring construct_graph.py:246-324).
    """
    win = genemer_windows(tokens, lengths, k)
    nh, nd, valid = win["node_hash"], win["direction"], win["valid"]
    if nh.shape[1] >= 2:
        src_h, tgt_h = nh[:, :-1], nh[:, 1:]
        src_d, tgt_d = nd[:, :-1], nd[:, 1:]
        e_fwd = edge_key(src_h, src_d, tgt_h, tgt_d)
        e_rev = edge_key(tgt_h, -tgt_d, src_h, -src_d)
        e_valid = valid[:, :-1] & valid[:, 1:]
    else:
        z = jnp.zeros((nh.shape[0], 0))
        e_fwd = e_rev = z.astype(jnp.uint64)
        e_valid = z.astype(bool)
    return nh, nd, valid, e_fwd, e_rev, e_valid


class Node:
    """Graph node = one canonical gene-mer (construct_node.py:4-154)."""

    __slots__ = (
        "hash",
        "tokens",  # canonical signed gene tokens, np.int32 (k,)
        "coverage",
        "reads",  # ordered list of read ids (dedup, first-occurrence order)
        "_read_set",
        "fwd_edges",  # edge keys where this node is source with direction +1
        "bwd_edges",  # edge keys where this node is source with direction -1
        "component",
        "color",
        "node_id",
    )

    def __init__(self, node_hash: int, tokens: np.ndarray):
        self.hash = node_hash
        self.tokens = tokens
        self.coverage = 0
        self.reads = []
        self._read_set = set()
        self.fwd_edges = []
        self.bwd_edges = []
        self.component = None
        self.color = None
        self.node_id = None

    # --- reference-compatible accessors ---
    def __hash__(self):
        return self.hash

    def get_node_coverage(self):
        return self.coverage

    def increment_node_coverage(self):
        self.coverage += 1
        return self.coverage

    def get_list_of_reads(self):
        return self.reads

    def get_reads(self):
        return iter(self.reads)

    def add_read(self, read_id: str):
        if read_id not in self._read_set:
            self._read_set.add(read_id)
            self.reads.append(read_id)

    def remove_read(self, read_id: str):
        self._read_set.discard(read_id)
        try:
            self.reads.remove(read_id)
        except ValueError:
            pass

    def get_forward_edge_hashes(self):
        return self.fwd_edges

    def get_backward_edge_hashes(self):
        return self.bwd_edges

    def get_component(self):
        return self.component

    def set_component(self, cid):
        self.component = int(cid)
        return self.component


class Edge:
    """Directed edge record with orientation (construct_edge.py:31-124)."""

    __slots__ = ("key", "src", "tgt", "src_dir", "tgt_dir", "coverage")

    def __init__(self, key, src, tgt, src_dir, tgt_dir):
        self.key = key
        self.src = src  # node hash
        self.tgt = tgt  # node hash
        self.src_dir = int(src_dir)
        self.tgt_dir = int(tgt_dir)
        self.coverage = 0

    def __hash__(self):
        return self.key

    def get_sourceNode(self):  # kept name-compatible for porting ease
        return self.src

    def get_targetNode(self):
        return self.tgt

    def get_sourceNodeDirection(self):
        return self.src_dir

    def get_targetNodeDirection(self):
        return self.tgt_dir

    def get_edge_coverage(self):
        return self.coverage


def _bucket(n: int, minimum: int = 8) -> int:
    """Round up to the next power of two (shape-bucketing for jit)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _sliding_windows(arr2d: np.ndarray, k: int) -> np.ndarray:
    """(R, L) -> (R, W, k) view of all length-k windows."""
    from numpy.lib.stride_tricks import sliding_window_view

    return sliding_window_view(arr2d, k, axis=1)


class GeneMerGraph:
    def __init__(self, readDict, kmerSize, gene_positions=None, vocab=None, cache=None):
        self._reads = dict(readDict)
        self._kmerSize = int(kmerSize)
        self._genePositions = gene_positions
        self._minNodeCoverage = 1
        self._minEdgeCoverage = 1
        self.vocab = vocab if vocab is not None else GeneVocab()
        self._cache = cache
        self._nodes_d: dict[int, Node] = {}
        self._edges_d: dict[int, Edge] = {}
        self._readNodes_d: dict[str, list] = {}
        self._readNodeDirections_d: dict[str, list] = {}
        self._readNodePositions_d: dict[str, list] = {}
        self._shortReads: dict[str, list] = {}
        self._readsToCorrect: set[str] = set()
        # Cached builds are LAZY: only flat numpy tables are aggregated up
        # front; the Node/Edge object graph and per-read lists materialize on
        # first dict access. The tensor cleaning path (amira_tpu/clean.py)
        # works off the tables and never pays for materialization.
        self._lazy: dict | None = None
        if cache is not None:
            self._build_cached()
        else:
            self._build()

    # ---------------------------------------------------- lazy materialization

    @property
    def _nodes(self) -> dict[int, Node]:
        if self._lazy is not None:
            self._materialize()
        return self._nodes_d

    @property
    def _edges(self) -> dict[int, Edge]:
        if self._lazy is not None:
            self._materialize()
        return self._edges_d

    @property
    def _readNodes(self) -> dict[str, list]:
        if self._lazy is not None:
            self._materialize()
        return self._readNodes_d

    @property
    def _readNodeDirections(self) -> dict[str, list]:
        if self._lazy is not None:
            self._materialize()
        return self._readNodeDirections_d

    @property
    def _readNodePositions(self) -> dict[str, list]:
        if self._lazy is not None:
            self._materialize()
        return self._readNodePositions_d

    @property
    def is_lazy(self) -> bool:
        return self._lazy is not None

    def lazy_tables(self) -> dict | None:
        """The flat aggregation tables of a lazy cached build (see
        _build_cached), or None once materialized/for device builds."""
        return self._lazy

    # ------------------------------------------------------------------ build

    def _build(self):
        k = self._kmerSize
        read_ids = list(self._reads.keys())
        if not read_ids:
            return
        tok_list = self.vocab.encode_reads_batch(
            [self._reads[r] for r in read_ids]
        )
        lengths = np.asarray([len(t) for t in tok_list], dtype=np.int32)

        # short reads (< k genes) contribute nothing to the graph
        for i, r in enumerate(read_ids):
            if lengths[i] < k:
                self._shortReads[r] = self._reads[r]

        keep = lengths >= k
        if not keep.any():
            return
        kept_ids = [r for r, m in zip(read_ids, keep) if m]
        kept_tok = [t for t, m in zip(tok_list, keep) if m]
        kept_len = np.asarray([len(t) for t in kept_tok], dtype=np.int32)

        # ---- length-bucketed kernel launches: reads are grouped by
        # next-power-of-two gene count so the device never pays for padding
        # beyond 2x, and jit compiles once per (k, L_bucket, R_bucket).
        # Kernel outputs stay on device; the sort/unique/segment table
        # assembly (amira_tpu/ops/graph_tables.py) runs there too, and only
        # boundary-masked tables come back to the host.
        from amira_tpu.ops.graph_tables import (
            assemble_edge_tables,
            assemble_node_tables,
            bucket_occurrences,
        )

        order_by_len = np.argsort(kept_len, kind="stable")
        dev_parts = []  # per-bucket device arrays
        host_win = {}  # per-bucket (rows sel, host hash/dir matrices)
        i = 0
        while i < len(order_by_len):
            lb = _bucket(int(kept_len[order_by_len[i]]))
            j = i
            while j < len(order_by_len) and _bucket(int(kept_len[order_by_len[j]])) == lb:
                j += 1
            sel = order_by_len[i:j]
            i = j
            btoks = [kept_tok[s] for s in sel]
            tokens, klengths = pack_reads(btoks, pad_to=lb)
            n_pad = _bucket(len(btoks)) - len(btoks)
            if n_pad:
                tokens = np.vstack(
                    [tokens, np.zeros((n_pad, lb), dtype=np.int32)]
                )
                klengths = np.concatenate([klengths, np.zeros(n_pad, np.int32)])
            sel_arr = np.full(len(btoks) + n_pad, -1, dtype=np.int32)
            sel_arr[: len(btoks)] = sel
            out = bucket_occurrences(tokens, klengths, sel_arr, k)
            dev_parts.append(out)
            host_win[lb] = (sel, out[0], out[1], lb - k + 1)

        occ_hash = jnp.concatenate([p[0] for p in dev_parts])
        occ_dir = jnp.concatenate([p[1] for p in dev_parts])
        occ_read = jnp.concatenate([p[2] for p in dev_parts])
        occ_key = jnp.concatenate([p[3] for p in dev_parts])
        ekeys = jnp.concatenate([p[4] for p in dev_parts])
        eokey = jnp.concatenate([p[5] for p in dev_parts])
        sh, boundary, run_key, run_cov, pboundary, pair_run, pair_read = (
            assemble_node_tables(occ_hash, occ_read, occ_key, len(kept_ids))
        )
        esk, eboundary, ecov, eokey_s = assemble_edge_tables(ekeys, eokey)

        # ---- per-read window hash/direction arrays: one packed uint32
        # device-to-host copy per bucket
        from amira_tpu.ops.graph_tables import join_u64, pack_bucket

        win_hash = {}
        win_dir = {}
        for lb, (sel, dev_h, dev_d, W) in host_win.items():
            packed = np.asarray(pack_bucket(dev_h, dev_d))
            n = packed.shape[0] // 3
            hh = join_u64(packed[:n], packed[n : 2 * n]).reshape(-1, W)
            dd = (packed[2 * n :].astype(np.int8) - 1).reshape(-1, W)
            for row, s in enumerate(sel):
                w = int(kept_len[s]) - (k - 1)
                win_hash[int(s)] = hh[row, :w]
                win_dir[int(s)] = dd[row, :w]
        has_pos = self._genePositions is not None
        for s, rid in enumerate(kept_ids):
            wh = win_hash[s]
            self._readNodes[rid] = wh.tolist()
            self._readNodeDirections[rid] = win_dir[s].tolist()
            if has_pos:
                pos = self._genePositions[rid]
                self._readNodePositions[rid] = [
                    (pos[j2][0], pos[j2 + k - 1][1]) for j2 in range(len(wh))
                ]
            else:
                self._readNodePositions[rid] = [None] * len(wh)

        # ---- compact tables on device; counts in one round trip, the whole
        # table set in one more
        from amira_tpu.ops.graph_tables import compact_all, count_true3

        n_nodes, n_pairs, n_edges = (
            int(x) for x in np.asarray(count_true3(boundary, pboundary, eboundary))
        )
        Cn = _bucket(n_nodes, 256)
        Cp = _bucket(n_pairs, 256)
        Ce = _bucket(max(n_edges, 1), 256)
        packed_tables = np.asarray(
            compact_all(
                sh, boundary, run_key, run_cov,
                pboundary, pair_run, pair_read,
                esk, eboundary, ecov, eokey_s,
                Cn, Cp, Ce,
            )
        )
        nt = packed_tables[: 5 * Cn].reshape(5, Cn)
        pt = packed_tables[5 * Cn : 5 * Cn + 2 * Cp].reshape(2, Cp)
        et = packed_tables[5 * Cn + 2 * Cp :].reshape(5, Ce)
        node_hashes = join_u64(nt[0], nt[1])[:n_nodes]
        node_keys = join_u64(nt[2], nt[3])[:n_nodes].astype(np.int64)
        node_covs = nt[4][:n_nodes]
        first_read = (node_keys >> 22).astype(np.int64)
        first_w = ((node_keys >> 1) & ((1 << 21) - 1)).astype(np.int64)

        nodes_in_run_order = []
        for gi in range(n_nodes):
            ri, wi = int(first_read[gi]), int(first_w[gi])
            wtok = kept_tok[ri][wi : wi + k]
            d_first = int(win_dir[ri][wi])
            canon = wtok if d_first == 1 else reverse_tokens(wtok)
            node = Node(int(node_hashes[gi]), np.ascontiguousarray(canon))
            node.coverage = int(node_covs[gi])
            nodes_in_run_order.append(node)
        # insertion order = first-occurrence order (reference read-major)
        for gi in np.argsort(node_keys, kind="stable"):
            node = nodes_in_run_order[gi]
            self._nodes[node.hash] = node

        # ---- reads per node (compact pair tables, already (run, read) sorted)
        prun = pt[0][:n_pairs].astype(np.int64)
        pread = pt[1][:n_pairs].astype(np.int64)
        kept_arr = np.array(kept_ids, dtype=object)
        read_objs = kept_arr[pread]
        bounds = np.searchsorted(prun, np.arange(n_nodes + 1))
        for gi in range(n_nodes):
            node = nodes_in_run_order[gi]
            rids = read_objs[bounds[gi] : bounds[gi + 1]].tolist()
            node.reads = rids
            node._read_set = set(rids)

        # ---- edge table (endpoints reconstructed from the first-occurrence
        # order key: read index, window, fwd/rev slot)
        if n_edges:
            ekey_vals = join_u64(et[0], et[1])[:n_edges]
            ecov_vals = et[2][:n_edges]
            eokey_vals = join_u64(et[3], et[4])[:n_edges].astype(np.int64)
            e_read = (eokey_vals >> 22).astype(np.int64)
            e_w = ((eokey_vals >> 1) & ((1 << 21) - 1)).astype(np.int64)
            e_rev = (eokey_vals & 1).astype(bool)
            for gi in np.argsort(eokey_vals, kind="stable"):
                ri, wi = int(e_read[gi]), int(e_w[gi])
                wh = win_hash[ri]
                wd = win_dir[ri]
                src_h, tgt_h = int(wh[wi]), int(wh[wi + 1])
                src_d, tgt_d = int(wd[wi]), int(wd[wi + 1])
                if e_rev[gi]:
                    src_h, tgt_h = tgt_h, src_h
                    src_d, tgt_d = -tgt_d, -src_d
                key = int(ekey_vals[gi])
                edge = Edge(key, src_h, tgt_h, src_d, tgt_d)
                edge.coverage = int(ecov_vals[gi])
                self._edges[key] = edge
                src_node = self._nodes[src_h]
                lst = src_node.fwd_edges if src_d == 1 else src_node.bwd_edges
                if key not in lst:
                    lst.append(key)

        self.assign_component_ids()

    # -------------------------------------------------- incremental build

    def _build_cached(self):
        """Build via the incremental cache (amira_tpu/graph_cache.py).

        Device kernels run only for reads whose gene annotation changed since
        they were last seen at this k; node/edge/coverage tables are
        re-aggregated from cached per-read occurrence vectors with vectorized
        host group-bys. Produces a graph identical (including dict insertion
        order and per-node read/edge-list order) to _build()."""
        k = self._kmerSize
        cache = self._cache
        cache.bind_vocab(self.vocab)
        store = cache.store(k)
        read_ids = list(self._reads.keys())
        if not read_ids:
            return
        has_pos = self._genePositions is not None

        kept_ids: list[str] = []
        entries: list = []
        miss_pos: list[int] = []
        for rid in read_ids:
            genes = self._reads[rid]
            if len(genes) < k:
                self._shortReads[rid] = genes
                continue
            e = store.get(rid)
            if e is not None:
                if e.genes_src is genes:
                    pass  # same object as last build: O(1) hit
                elif e.genes == genes:
                    e.genes_src = genes
                else:
                    e = None
            kept_ids.append(rid)
            entries.append(e)
            if e is None:
                miss_pos.append(len(kept_ids) - 1)
        if not kept_ids:
            return
        cache.hits += len(kept_ids) - len(miss_pos)
        cache.misses += len(miss_pos)

        if miss_pos:
            self._compute_cache_misses(store, kept_ids, entries, miss_pos, k)

        # ---- aggregation: group window occurrences by hash on the host.
        # The concatenated occurrence streams are SPLICED from the previous
        # build's arrays when the kept-read sequence is unchanged except for
        # cache misses (the cleaning loop's steady state): runs of unchanged
        # reads copy as single slices, so stream assembly is O(changed), not
        # one np.concatenate over ~10^5 small per-read arrays. Grouping uses
        # plain sort + searchsorted + bincount (no stable argsort, which is
        # what makes np.unique(return_index/inverse) 3-4x slower); the
        # first-occurrence map is computed lazily (_first_occurrence) via a
        # reversed fancy-scatter. Everything beyond these flat tables
        # (Node/Edge objects, per-read template lists, reads-per-node) is
        # deferred to _materialize().
        n_entries = len(entries)
        prev = cache.streams.get(k)
        spliced = None
        if prev is not None and len(prev["entries"]) == n_entries:
            miss_set = set(miss_pos)
            pe = prev["entries"]
            if all(
                entries[i] is pe[i] for i in range(n_entries) if i not in miss_set
            ):
                spliced = self._splice_streams(prev, entries, miss_pos)
        if spliced is not None:
            occ, wd_cat, wlens, offs = spliced
        else:
            wh_list = [e.wh for e in entries]
            wlens = np.fromiter((len(w) for w in wh_list), np.int64, n_entries)
            offs = np.zeros(n_entries + 1, np.int64)
            np.cumsum(wlens, out=offs[1:])
            occ = np.concatenate(wh_list)
            wd_cat = np.concatenate([e.wd for e in entries])
        uh = np.unique(occ)
        inv = np.searchsorted(uh, occ)
        counts = np.bincount(inv, minlength=len(uh))
        cache.streams[k] = {
            "entries": list(entries),
            "occ": occ,
            "wd_cat": wd_cat,
            "wlens": wlens,
            "offs": offs,
        }
        self._lazy = {
            "entries": entries,
            "kept_ids": kept_ids,
            "occ": occ,
            "offs": offs,
            "wlens": wlens,
            "wd_cat": wd_cat,
            "uh": uh,
            "inv": inv,
            "counts": counts,
            "first_idx": None,
            "edges": None,
        }

    @staticmethod
    def _splice_streams(prev, entries, miss_pos):
        """New (occ, wd_cat, wlens, offs) by splicing the previous build's
        streams: maximal runs of unchanged reads are copied as single
        slices; only cache-miss reads contribute fresh per-read arrays."""
        p_occ, p_wd = prev["occ"], prev["wd_cat"]
        p_offs = prev["offs"]
        n = len(entries)
        wlens = prev["wlens"].copy()
        occ_pieces = []
        wd_pieces = []
        run_start = 0
        for c in miss_pos:
            if c > run_start:
                occ_pieces.append(p_occ[p_offs[run_start] : p_offs[c]])
                wd_pieces.append(p_wd[p_offs[run_start] : p_offs[c]])
            e = entries[c]
            occ_pieces.append(e.wh)
            wd_pieces.append(e.wd)
            wlens[c] = len(e.wh)
            run_start = c + 1
        if run_start < n:
            occ_pieces.append(p_occ[p_offs[run_start] : p_offs[n]])
            wd_pieces.append(p_wd[p_offs[run_start] : p_offs[n]])
        occ = np.concatenate(occ_pieces) if occ_pieces else np.zeros(0, np.uint64)
        wd_cat = np.concatenate(wd_pieces) if wd_pieces else np.zeros(0, np.int8)
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(wlens, out=offs[1:])
        return occ, wd_cat, wlens, offs

    def _first_occurrence(self):
        """first_idx/f_read/f_w of the lazy tables: index of each unique
        node's first occurrence in the concatenated window stream (defines
        the reference's read-major insertion order). Reversed fancy-scatter:
        with repeated indices the LAST write wins, so scattering positions
        in reverse leaves the minimum."""
        lz = self._lazy
        if lz["first_idx"] is None:
            occ_n = len(lz["occ"])
            first = np.empty(len(lz["uh"]), np.int64)
            first[lz["inv"][::-1]] = np.arange(occ_n - 1, -1, -1, np.int64)
            lz["first_idx"] = first
            f_read = np.searchsorted(lz["offs"], first, side="right") - 1
            lz["f_read"] = f_read
            lz["f_w"] = first - lz["offs"][f_read]
        return lz["first_idx"]

    def _edge_table(self):
        """Unique-edge arrays of a lazy build: (uek, cov, first_occ, src_h,
        tgt_h, src_d, tgt_d, src_idx, tgt_idx). Edge identity is computed as
        a composite (node_idx, dir) pair code over the occurrence stream —
        no per-occurrence hashing, no per-read key arrays — then grouped
        with one stable argsort; the real canonical edge-key hashes
        (Edge.__hash__ parity with device builds, construct_edge.py:104-124)
        are computed only for the ~unique records. src_idx/tgt_idx index the
        sorted unique-node table `uh`; `first_occ` orders edges by first
        occurrence in the interleaved (fwd, rc-companion) record stream,
        matching the object build's insertion order."""
        lz = self._lazy
        if lz["edges"] is None:
            from amira_tpu.ops.host_tables import _edge_key

            occ, offs, inv = lz["occ"], lz["offs"], lz["inv"]
            if lz.get("wd_cat") is None:
                lz["wd_cat"] = np.concatenate(
                    [e.wd for e in lz["entries"]]
                ) if lz["entries"] else np.zeros(0, np.int8)
            wd_cat = lz["wd_cat"]
            n_pairs_total = len(occ) - (len(offs) - 1)
            if n_pairs_total > 0:
                valid = np.ones(len(occ), dtype=bool)
                valid[offs[1:] - 1] = False  # last window of each read
                p0 = np.flatnonzero(valid)
                i0 = inv[p0].astype(np.int64)
                i1 = inv[p0 + 1].astype(np.int64)
                a0 = (i0 << 1) | (wd_cat[p0] > 0)
                a1 = (i1 << 1) | (wd_cat[p0 + 1] > 0)
                # orbit {(a,b), (a^1,b^1)}: the lexicographic min is decided
                # by the direction bit of the first element alone
                cf = np.where(
                    (a0 & 1).astype(bool),
                    ((a0 ^ 1) << 32) | (a1 ^ 1),
                    (a0 << 32) | a1,
                )
                x, y = a1 ^ 1, a0 ^ 1
                cr = np.where(
                    (x & 1).astype(bool),
                    ((x ^ 1) << 32) | (y ^ 1),
                    (x << 32) | y,
                )
                codes = np.empty(2 * len(p0), np.int64)
                codes[0::2] = cf
                codes[1::2] = cr
                order = np.argsort(codes, kind="stable")
                s = codes[order]
                flags = np.empty(len(s), bool)
                flags[0] = True
                np.not_equal(s[1:], s[:-1], out=flags[1:])
                starts = np.flatnonzero(flags)
                e_first = order[starts]
                e_counts = np.diff(np.append(starts, len(s)))
                pair_pos = e_first >> 1
                rev = (e_first & 1).astype(bool)
                base = p0[pair_pos]
                w0_h, w1_h = occ[base], occ[base + 1]
                w0_d = wd_cat[base].astype(np.int64)
                w1_d = wd_cat[base + 1].astype(np.int64)
                w0_i, w1_i = inv[base], inv[base + 1]
                src_hs = np.where(rev, w1_h, w0_h)
                tgt_hs = np.where(rev, w0_h, w1_h)
                src_ds = np.where(rev, -w1_d, w0_d)
                tgt_ds = np.where(rev, -w0_d, w1_d)
                src_is = np.where(rev, w1_i, w0_i).astype(np.int64)
                tgt_is = np.where(rev, w0_i, w1_i).astype(np.int64)
                uek = _edge_key(src_hs, src_ds, tgt_hs, tgt_ds)
            else:
                z64 = np.zeros(0, np.int64)
                uek = np.zeros(0, np.uint64)
                e_counts, e_first = z64, z64
                src_hs = tgt_hs = uek
                src_ds = tgt_ds = src_is = tgt_is = z64
            lz["edges"] = (
                uek, e_counts, e_first, src_hs, tgt_hs, src_ds, tgt_ds,
                src_is, tgt_is,
            )
        return lz["edges"]

    def node_tokens_for(self, node_hashes):
        """Canonical signed token arrays for node hashes of a LAZY build
        (first-occurrence extraction, same as Node.tokens)."""
        self._first_occurrence()
        lz = self._lazy
        k = self._kmerSize
        idx = np.searchsorted(lz["uh"], np.asarray(node_hashes, dtype=np.uint64))
        out = []
        for j, h in zip(idx.tolist(), node_hashes):
            e = lz["entries"][int(lz["f_read"][j])]
            wi = int(lz["f_w"][j])
            wtok = e.tok[wi : wi + k]
            out.append(
                np.ascontiguousarray(
                    wtok if int(e.wd[wi]) == 1 else reverse_tokens(wtok)
                )
            )
        return out

    def _materialize(self):
        """Build the Node/Edge object graph + per-read lists from the lazy
        aggregation tables. Produces exactly the structures (including dict
        insertion order and per-node read/edge-list order) the eager build
        produced before laziness was introduced."""
        self._first_occurrence()
        lz, self._lazy = self._lazy, None
        k = self._kmerSize
        entries, kept_ids = lz["entries"], lz["kept_ids"]
        has_pos = self._genePositions is not None

        # ---- per-read tables from cached templates
        rn, rd, rp = self._readNodes_d, self._readNodeDirections_d, self._readNodePositions_d
        if has_pos:
            gpos = self._genePositions
        for i, rid in enumerate(kept_ids):
            e = entries[i]
            rn[rid] = e.nodes_list()[:]
            rd[rid] = e.dirs_list()[:]
            if has_pos:
                pos = gpos[rid]
                if e.pos_src is not pos:
                    e.pos_tpl = [
                        (pos[j][0], pos[j + k - 1][1])
                        for j in range(len(e.nodes_tpl))
                    ]
                    e.pos_src = pos
                rp[rid] = e.pos_tpl[:]
            else:
                rp[rid] = [None] * len(e.nodes_tpl)

        uh, first_idx, counts = lz["uh"], lz["first_idx"], lz["counts"]
        f_read, f_w = lz["f_read"], lz["f_w"]
        n_nodes = len(uh)
        nodes_in_run_order = []
        uh_l = uh.tolist()
        covs_l = counts.tolist()
        for gi, (ri, wi) in enumerate(zip(f_read.tolist(), f_w.tolist())):
            e = entries[ri]
            wtok = e.tok[wi : wi + k]
            canon = wtok if int(e.wd[wi]) == 1 else reverse_tokens(wtok)
            node = Node(uh_l[gi], np.ascontiguousarray(canon))
            node.coverage = covs_l[gi]
            nodes_in_run_order.append(node)
        # insertion order = first-occurrence order (reference read-major)
        for gi in np.argsort(first_idx, kind="stable").tolist():
            node = nodes_in_run_order[gi]
            self._nodes_d[node.hash] = node

        # ---- reads per node: unique (node-run, read) pairs
        n_entries = len(entries)
        occ_read = np.repeat(np.arange(n_entries, dtype=np.int64), lz["wlens"])
        pair_key = (lz["inv"].astype(np.uint64) << np.uint64(32)) | occ_read.astype(
            np.uint64
        )
        upairs = np.unique(pair_key)
        prun = (upairs >> np.uint64(32)).astype(np.int64)
        pread = (upairs & np.uint64(0xFFFFFFFF)).astype(np.int64)
        kept_arr = np.array(kept_ids, dtype=object)
        read_objs = kept_arr[pread]
        bounds = np.searchsorted(prun, np.arange(n_nodes + 1))
        for gi in range(n_nodes):
            node = nodes_in_run_order[gi]
            rids = read_objs[bounds[gi] : bounds[gi + 1]].tolist()
            node.reads = rids
            node._read_set = set(rids)

        # ---- edge objects from the unique-edge arrays
        self._lazy = lz  # _edge_table reads the lazy state
        uek, e_counts, e_first, src_hs, tgt_hs, src_ds, tgt_ds, _si, _ti = (
            self._edge_table()
        )
        self._lazy = None
        if uek.size:
            uek_l = uek.tolist()
            ecov_l = e_counts.tolist()
            src_hl, tgt_hl = src_hs.tolist(), tgt_hs.tolist()
            src_dl, tgt_dl = src_ds.tolist(), tgt_ds.tolist()
            for gi in np.argsort(e_first, kind="stable").tolist():
                key = uek_l[gi]
                src_h, src_d = src_hl[gi], src_dl[gi]
                edge = Edge(key, src_h, tgt_hl[gi], src_d, tgt_dl[gi])
                edge.coverage = ecov_l[gi]
                self._edges_d[key] = edge
                src_node = self._nodes_d[src_h]
                lst = src_node.fwd_edges if src_d == 1 else src_node.bwd_edges
                if key not in lst:
                    lst.append(key)

        self.assign_component_ids()

    def _compute_cache_misses(self, store, kept_ids, entries, miss_pos, k):
        """Windowing pass for the reads not in the cache; fills `store` and
        `entries`. Large batches run on the device as ONE flat-stream
        dispatch (ops/graph_tables.pack_flat_windows) — reads concatenated
        into a single 1-D token stream, no padding buckets, and edge keys
        derived on the host from the downloaded window stream (halves the
        device-to-host copy). Small batches (below HOST_BATCH_GENE_LIMIT
        genes) run entirely on the host NumPy mirror, which skips the
        dispatch and copy for the few-percent rebuild churn of a cleaning
        iteration (ops/host_tables.py, bit-identical by fuzz test)."""
        from amira_tpu.graph_cache import CacheEntry
        from amira_tpu.ops.graph_tables import join_u64, pack_flat_windows
        from amira_tpu.ops.host_tables import (
            HOST_BATCH_GENE_LIMIT,
            host_windows_edges,
        )

        genes_list = [self._reads[kept_ids[i]] for i in miss_pos]
        tok_list = self.vocab.encode_reads_batch(genes_list)
        lens = np.fromiter((len(t) for t in tok_list), np.int64, len(tok_list))
        if int(lens.sum()) <= HOST_BATCH_GENE_LIMIT:
            for s, (wh, wd, _ek) in enumerate(host_windows_edges(tok_list, k)):
                kp = miss_pos[s]
                rid = kept_ids[kp]
                e = CacheEntry()
                # no defensive copy: in-place mutation of a read's gene list
                # is unsupported (graph_cache.py module docstring)
                e.genes = self._reads[rid]
                e.genes_src = self._reads[rid]
                e.tok = tok_list[s]
                e.wh = wh
                e.wd = wd
                e.nodes_tpl = None
                e.dirs_tpl = None
                e.pos_src = None
                e.pos_tpl = None
                store[rid] = e
                entries[kp] = e
            return
        total = int(lens.sum())
        Nb = _bucket(total, 4096)
        flat = np.zeros(Nb, np.int32)
        starts = np.zeros(len(tok_list) + 1, np.int64)
        np.cumsum(lens, out=starts[1:])
        flat[:total] = np.concatenate(tok_list)
        buf = np.asarray(pack_flat_windows(flat, k))
        wh_all = join_u64(buf[:Nb], buf[Nb : 2 * Nb])
        wd_all = (buf[2 * Nb :].astype(np.int8) - 1)
        for s, tok in enumerate(tok_list):
            kp = miss_pos[s]
            rid = kept_ids[kp]
            o = int(starts[s])
            Wt = len(tok) - (k - 1)
            e = CacheEntry()
            e.genes = self._reads[rid]
            e.genes_src = self._reads[rid]
            e.tok = tok
            e.wh = wh_all[o : o + Wt]  # view; the flat buffer stays alive
            e.wd = wd_all[o : o + Wt]
            e.nodes_tpl = None
            e.dirs_tpl = None
            e.pos_src = None
            e.pos_tpl = None
            store[rid] = e
            entries[kp] = e

    def _finish_from_distributed_tables(
        self, kept_ids, tok_list, lens, offs,
        nk, nc, nf, ek2, ec, ef, wh_rows, wd_rows,
    ):
        """Assemble the lazy aggregation tables from a distributed build's
        collective-merged node/edge tables (parallel/distgraph.py:
        distributed_graph_build) + this host's window streams. The resulting
        graph is identical to a single-device build: counts, coverages and
        global first-occurrence orderkeys come from the mesh; incidence,
        canonical tokens and edge endpoints reconstruct from the streams."""
        from amira_tpu.graph_cache import CacheEntry

        k = self._kmerSize
        entries = []
        occ_parts, wd_parts = [], []
        for i, rid in enumerate(kept_ids):
            W = int(lens[i]) - (k - 1)
            e = CacheEntry()
            e.genes = self._reads[rid]
            e.genes_src = self._reads[rid]
            e.tok = tok_list[i]
            e.wh = np.ascontiguousarray(wh_rows[i, :W])
            e.wd = np.ascontiguousarray(wd_rows[i, :W])
            e.nodes_tpl = None
            e.dirs_tpl = None
            e.pos_src = None
            e.pos_tpl = None
            entries.append(e)
            occ_parts.append(e.wh)
            wd_parts.append(e.wd)
        occ = np.concatenate(occ_parts)
        wd_cat = np.concatenate(wd_parts)
        wlens = np.diff(offs)

        nmask = nk != 0
        if int(nmask.sum()) >= len(nk):
            raise ValueError(
                "distributed node table capacity overflow; raise node_cap"
            )
        uh = nk[nmask].astype(np.uint64)
        counts = nc[nmask].astype(np.int64)
        first_idx = nf[nmask].astype(np.int64)
        inv = np.searchsorted(uh, occ)
        f_read = np.searchsorted(offs, first_idx, side="right") - 1
        f_w = first_idx - offs[f_read]

        emask = ek2 != 0
        if int(emask.sum()) >= len(ek2):
            raise ValueError(
                "distributed edge table capacity overflow; raise edge_cap"
            )
        uek = ek2[emask].astype(np.uint64)
        e_counts = ec[emask].astype(np.int64)
        e_first = ef[emask].astype(np.int64)
        if uek.size:
            valid = np.ones(len(occ), dtype=bool)
            valid[offs[1:] - 1] = False
            p0 = np.flatnonzero(valid)
            pair_pos = e_first >> 1
            rev = (e_first & 1).astype(bool)
            base = p0[pair_pos]
            w0_h, w1_h = occ[base], occ[base + 1]
            w0_d = wd_cat[base].astype(np.int64)
            w1_d = wd_cat[base + 1].astype(np.int64)
            w0_i, w1_i = inv[base], inv[base + 1]
            src_hs = np.where(rev, w1_h, w0_h)
            tgt_hs = np.where(rev, w0_h, w1_h)
            src_ds = np.where(rev, -w1_d, w0_d)
            tgt_ds = np.where(rev, -w0_d, w1_d)
            src_is = np.where(rev, w1_i, w0_i).astype(np.int64)
            tgt_is = np.where(rev, w0_i, w1_i).astype(np.int64)
        else:
            z64 = np.zeros(0, np.int64)
            uek = np.zeros(0, np.uint64)
            e_counts = e_first = z64
            src_hs = tgt_hs = uek
            src_ds = tgt_ds = src_is = tgt_is = z64

        self._lazy = {
            "entries": entries,
            "kept_ids": kept_ids,
            "occ": occ,
            "offs": offs,
            "wlens": wlens,
            "wd_cat": wd_cat,
            "uh": uh,
            "inv": inv,
            "counts": counts,
            "first_idx": first_idx,
            "f_read": f_read,
            "f_w": f_w,
            "edges": (
                uek, e_counts, e_first, src_hs, tgt_hs, src_ds, tgt_ds,
                src_is, tgt_is,
            ),
        }

    # ------------------------------------------------------------- accessors

    def get_reads(self):
        return self._reads

    def get_gene_positions(self):
        return self._genePositions

    def get_readNodes(self):
        return self._readNodes

    def get_readNodeDirections(self):
        return self._readNodeDirections

    def get_readNodePositions(self):
        return self._readNodePositions

    def get_kmerSize(self):
        return self._kmerSize

    def get_nodes(self):
        return self._nodes

    def get_edges(self):
        return self._edges

    def get_minNodeCoverage(self):
        return self._minNodeCoverage

    def get_minEdgeCoverage(self):
        return self._minEdgeCoverage

    def get_short_read_annotations(self):
        return self._shortReads

    def get_short_read_gene_positions(self):
        if self._genePositions is None:
            return {}
        return {r: self._genePositions[r] for r in self._shortReads}

    def get_reads_to_correct(self):
        return self._readsToCorrect

    def all_nodes(self):
        return iter(list(self._nodes.values()))

    def get_node_by_hash(self, h) -> Node:
        return self._nodes[h]

    def get_edge_by_hash(self, key) -> Edge:
        return self._edges[key]

    def get_total_number_of_nodes(self):
        if self._lazy is not None:
            return len(self._lazy["uh"])
        return len(self._nodes_d)

    def get_total_number_of_edges(self):
        if self._lazy is not None:
            return len(self._edge_table()[0])
        return len(self._edges_d)

    def get_total_number_of_reads(self):
        return len(self._reads)

    def get_reads_for_nodes(self, node_hashes) -> set:
        reads = set()
        for h in node_hashes:
            if h in self._nodes:
                reads.update(self._nodes[h].reads)
        return reads

    def get_nodes_containing_read(self, read_id: str) -> list:
        """Unfiltered nodes still on a read (construct_graph.py:180-186).

        Raises KeyError for a read the graph has never seen, matching the
        reference's direct-index semantics."""
        return [
            self._nodes[h]
            for h in self._readNodes[read_id]
            if h is not None and h in self._nodes
        ]

    def collect_reads_in_path(self, path) -> set:
        reads = set()
        for h in path:
            node = self._nodes.get(h)
            if node is not None:
                reads.update(node.reads)
        return reads

    # ------------------------------------------------ gene-name conversions

    def get_gene_mer_genes(self, node: Node) -> list[str]:
        """Stranded gene strings of the canonical gene-mer."""
        return [self.vocab.decode_gene(t) for t in node.tokens]

    def get_reverse_gene_mer_genes(self, node: Node) -> list[str]:
        return [self.vocab.decode_gene(t) for t in reverse_tokens(node.tokens)]

    def get_gene_mer_label(self, node: Node) -> str:
        return "~~~".join(self.get_gene_mer_genes(node))

    def reverse_list_of_genes(self, genes: list[str]) -> list[str]:
        return [("-" if g[0] == "+" else "+") + g[1:] for g in reversed(genes)]

    def get_nodes_containing(self, gene_name: str) -> list[Node]:
        """All nodes whose gene-mer contains the (strandless) gene."""
        assert gene_name[0] not in "+-", (
            "Strand information cannot be present for any specified genes"
        )
        if gene_name not in self.vocab:
            return []
        gid = self.vocab.id_of(gene_name)
        return [n for n in self._nodes.values() if gid in np.abs(n.tokens)]

    def get_AMR_nodes(self, gene_names) -> dict[int, Node]:
        amr = {}
        gids = {self.vocab.id_of(g) for g in gene_names if g in self.vocab}
        if not gids:
            return amr
        for node in self._nodes.values():
            if any(int(a) in gids for a in np.abs(node.tokens)):
                amr[node.hash] = node
        return amr

    def get_nodes_with_degree(self, degree: int):
        assert isinstance(degree, int), "The input degree must be an integer."
        return [n for n in self.all_nodes() if self.get_degree(n) == degree]

    # -------------------------------------------------------------- topology

    def get_degree(self, node: Node) -> int:
        return len(node.fwd_edges) + len(node.bwd_edges)

    def get_forward_edges(self, node: Node):
        return [self._edges[k] for k in node.fwd_edges]

    def get_backward_edges(self, node: Node):
        return [self._edges[k] for k in node.bwd_edges]

    def get_forward_neighbors(self, node: Node):
        return [self._nodes[e.tgt] for e in self.get_forward_edges(node)]

    def get_backward_neighbors(self, node: Node):
        return [self._nodes[e.tgt] for e in self.get_backward_edges(node)]

    def get_all_neighbors(self, node: Node):
        return self.get_forward_neighbors(node) + self.get_backward_neighbors(node)

    def get_all_neighbor_hashes(self, node: Node) -> set:
        return {
            self._edges[key].tgt for key in node.fwd_edges + node.bwd_edges
        }

    def check_if_nodes_are_adjacent(self, a: Node, b: Node) -> bool:
        return b.hash in self.get_all_neighbor_hashes(a) and a.hash in self.get_all_neighbor_hashes(b)

    def get_edge_hashes_between_nodes(self, a: Node, b: Node):
        """(a->b edge key(s), b->a edge key(s)); scalars when unambiguous.

        Mirrors construct_graph.py:364-386.
        """
        ab = [k for k in a.fwd_edges + a.bwd_edges if self._edges[k].tgt == b.hash]
        ba = [k for k in b.fwd_edges + b.bwd_edges if self._edges[k].tgt == a.hash]
        assert ab and ba, "There are edges missing from the source and target nodes"
        if len(ab) == 1 and len(ba) == 1:
            return (ab[0], ba[0])
        return (ab, ba)

    def get_edges_between_nodes(self, a: Node, b: Node):
        ab, ba = self.get_edge_hashes_between_nodes(a, b)
        if not isinstance(ab, list):
            return self._edges[ab], self._edges[ba]
        return [self._edges[k] for k in ab], [self._edges[k] for k in ba]

    def get_direction_between_two_nodes(self, src_hash, tgt_hash):
        s2t, _ = self.get_edges_between_nodes(
            self._nodes[src_hash], self._nodes[tgt_hash]
        )
        if isinstance(s2t, list):
            s2t = s2t[0]
        return s2t.tgt_dir * -1

    # -------------------------------------------------------------- mutation

    def remove_edge(self, key):
        if key not in self._edges:
            return
        edge = self._edges[key]
        src = self._nodes.get(edge.src)
        if src is not None:
            lst = src.fwd_edges if edge.src_dir == 1 else src.bwd_edges
            try:
                lst.remove(key)
            except ValueError:
                pass
        del self._edges[key]

    def remove_node_from_reads(self, node: Node):
        """Null the node out of every read's node list and mark those reads
        for correction (construct_graph.py:442-461)."""
        h = node.hash
        for rid in node.reads:
            nodes = self._readNodes.get(rid)
            if nodes is None:
                continue
            dirs = self._readNodeDirections[rid]
            poss = self._readNodePositions[rid]
            for i in range(len(nodes)):
                if nodes[i] == h:
                    nodes[i] = None
                    dirs[i] = None
                    poss[i] = None
            self._readsToCorrect.add(rid)

    def remove_node(self, node: Node):
        h = node.hash
        assert h in self._nodes, "This node is not in the graph"
        self.remove_node_from_reads(node)
        # remove every edge between this node and each neighbor (both
        # directions), matching construct_graph.py:472-482
        for key in list(set(node.fwd_edges + node.bwd_edges)):
            if key not in self._edges:
                continue
            tgt_hash = self._edges[key].tgt
            tgt = self._nodes.get(tgt_hash)
            if tgt is None or tgt_hash == h:
                self.remove_edge(key)
                continue
            ab = [k for k in node.fwd_edges + node.bwd_edges if self._edges[k].tgt == tgt_hash]
            ba = [k for k in tgt.fwd_edges + tgt.bwd_edges if self._edges[k].tgt == h]
            for e in ab + ba:
                self.remove_edge(e)
        del self._nodes[h]

    def list_nodes_to_remove(self, min_node_coverage):
        return {
            n for n in self._nodes.values() if n.coverage < min_node_coverage
        }

    def filter_graph(self, minNodeCoverage, minEdgeCoverage):
        self._minNodeCoverage = minNodeCoverage
        self._minEdgeCoverage = minEdgeCoverage
        nodes_to_remove = self.list_nodes_to_remove(minNodeCoverage)
        doomed_hashes = {n.hash for n in nodes_to_remove}
        edges_to_remove = [
            k
            for k, e in self._edges.items()
            if e.coverage < minEdgeCoverage
            or e.src in doomed_hashes
            or e.tgt in doomed_hashes
        ]
        for k in edges_to_remove:
            self.remove_edge(k)
        for n in nodes_to_remove:
            self.remove_node(n)
        return self

    # ------------------------------------------------------------ components

    def assign_component_ids(self):
        """Connected-component labelling via iterative BFS (replaces the
        reference's recursive DFS, construct_graph.py:911-927, which hits a
        50k recursion wall)."""
        visited = set()
        cid = 0
        for h, node in self._nodes.items():
            if h in visited:
                continue
            cid += 1
            stack = [h]
            visited.add(h)
            while stack:
                cur = stack.pop()
                cur_node = self._nodes[cur]
                cur_node.component = cid
                for nb in self.get_all_neighbor_hashes(cur_node):
                    if nb not in visited:
                        visited.add(nb)
                        stack.append(nb)

    def components(self):
        return sorted({n.component for n in self._nodes.values()})

    def get_number_of_component(self):
        return len(self.components())

    def get_nodes_in_component(self, component):
        component = int(component)
        return [n for n in self._nodes.values() if n.component == component]

    def remove_low_coverage_components(self, min_component_coverage):
        for cid in self.components():
            nodes = self.get_nodes_in_component(cid)
            if all(n.coverage < min_component_coverage for n in nodes):
                for n in nodes:
                    self.remove_node(n)

    # ---------------------------------------------------------- linear paths

    def get_forward_node_from_node(self, node: Node):
        if len(node.fwd_edges) == 1:
            edge = self._edges[node.fwd_edges[0]]
            tgt = self._nodes[edge.tgt]
            deg = self.get_degree(tgt)
            if deg <= 2 and tgt.hash != node.hash:
                return True, tgt, edge.tgt_dir
            return False, tgt, edge.tgt_dir
        return False, None, None

    def get_backward_node_from_node(self, node: Node):
        # NOTE: the forward walk requires exactly one forward edge but the
        # backward walk follows the FIRST backward edge whenever any exist —
        # this asymmetry mirrors the reference (construct_graph.py:781-802)
        # and is relied on by its tip-trimming behavior.
        if len(node.bwd_edges) > 0:
            edge = self._edges[node.bwd_edges[0]]
            tgt = self._nodes[edge.tgt]
            deg = self.get_degree(tgt)
            if deg <= 2 and tgt.hash != node.hash:
                return True, tgt, edge.tgt_dir
            return False, tgt, edge.tgt_dir
        return False, None, None

    def get_forward_path_from_node(self, node: Node, start_direction, want_branched=False):
        path = [node.hash]
        step = (
            self.get_forward_node_from_node
            if start_direction == 1
            else self.get_backward_node_from_node
        )
        extend, nxt, nxt_dir = step(node)
        while extend:
            if path[0] == nxt.hash:
                break
            path.append(nxt.hash)
            step = (
                self.get_forward_node_from_node
                if nxt_dir == 1
                else self.get_backward_node_from_node
            )
            extend, nxt, nxt_dir = step(nxt)
        if want_branched and nxt is not None:
            path.append(nxt.hash)
        return path

    def get_backward_path_from_node(self, node: Node, start_direction, want_branched=False):
        path = [node.hash]
        step = (
            self.get_backward_node_from_node
            if start_direction == -1
            else self.get_forward_node_from_node
        )
        extend, nxt, nxt_dir = step(node)
        while extend:
            if path[-1] == nxt.hash:
                break
            path.insert(0, nxt.hash)
            step = (
                self.get_backward_node_from_node
                if nxt_dir == -1
                else self.get_forward_node_from_node
            )
            extend, nxt, nxt_dir = step(nxt)
        if want_branched and nxt is not None:
            path.insert(0, nxt.hash)
        return path

    def _node_observed_direction(self, node: Node):
        """Direction of the first stored occurrence of this gene-mer.

        The reference keeps the GeneMer of the first occurrence on the Node
        and uses its direction to seed linear-path walks
        (construct_graph.py:849-861); equivalently this is +1 because the
        canonical tokens were extracted from that first occurrence.
        """
        return 1

    def get_linear_path_for_node(self, node: Node, want_branched=False):
        d = self._node_observed_direction(node)
        backward = self.get_backward_path_from_node(node, -d, want_branched)
        forward = self.get_forward_path_from_node(node, d, want_branched)
        assert backward[-1] == node.hash
        assert forward[0] == node.hash
        return backward[:-1] + [node.hash] + forward[1:]

    # ------------------------------------------------------------- coverages

    def get_all_node_coverages(self):
        return [n.coverage for n in self._nodes.values()]

    def get_mean_node_coverage(self):
        covs = self.get_all_node_coverages()
        return float(np.mean(covs)) if covs else 0.0

    def calculate_mean_node_coverage(self):
        return self.get_mean_node_coverage()

    # --------------------------------------------------- unitigs / gene lists

    def get_genes_in_unitig(self, node_path):
        """Stitch stranded gene strings along a node path, reconciling
        per-node orientations (construct_graph.py:617-677)."""
        if len(node_path) == 1:
            return self.get_gene_mer_genes(self._nodes[node_path[0]])
        k = self._kmerSize
        annotations: list[str] = []
        errored = False
        for i in range(len(node_path) - 1):
            src = self._nodes[node_path[i]]
            tgt = self._nodes[node_path[i + 1]]
            keys = self.get_edge_hashes_between_nodes(src, tgt)
            key0 = keys[0] if not isinstance(keys[0], list) else keys[0][0]
            edge = self._edges[key0]
            if i == 0:
                if edge.src_dir == 1:
                    annotations += self.get_gene_mer_genes(src)
                else:
                    annotations += self.get_reverse_gene_mer_genes(src)
            fw = self.get_gene_mer_genes(tgt)
            bw = self.get_reverse_gene_mer_genes(tgt)
            if fw[:-1] == annotations[-(k - 1):]:
                annotations.append(fw[-1])
            elif bw[:-1] == annotations[-(k - 1):]:
                annotations.append(bw[-1])
            else:
                errored = True
                break
        if not errored:
            return annotations
        # fallback: extend leftwards instead (reference's alternative pass)
        annotations = []
        for i in range(len(node_path) - 1):
            src = self._nodes[node_path[i]]
            tgt = self._nodes[node_path[i + 1]]
            keys = self.get_edge_hashes_between_nodes(src, tgt)
            key0 = keys[0] if not isinstance(keys[0], list) else keys[0][0]
            edge = self._edges[key0]
            if i == 0:
                annotations += (
                    self.get_gene_mer_genes(src)
                    if edge.src_dir == 1
                    else self.get_reverse_gene_mer_genes(src)
                )
            fw = self.get_gene_mer_genes(tgt)
            bw = self.get_reverse_gene_mer_genes(tgt)
            if fw[1:] == annotations[: k - 1]:
                annotations.insert(0, fw[0])
            elif bw[1:] == annotations[: k - 1]:
                annotations.insert(0, bw[0])
            else:
                raise ValueError("Gene sequences do not match in alternative path.")
        return annotations

    def get_annotation_for_read(self, node_list, node_directions, read_id):
        """Rebuild the stranded gene list of a read from a node path
        (construct_graph.py:1331-1373)."""
        assert len(node_list) == len(node_directions), (
            f"The number of nodes and node directions for read {read_id} differ"
        )
        if not node_directions:
            node_directions = self._readNodeDirections[read_id]
        if len(node_list) == 1:
            d = node_directions[0]
            node = self._nodes[node_list[0]]
            if d == 1:
                return self.get_gene_mer_genes(node)
            if d == -1:
                return self.get_reverse_gene_mer_genes(node)
            raise ValueError(f"Gene-mer direction cannot be {d}")
        annotations: list[str] = []
        for i, h in enumerate(node_list):
            node = self._nodes[h]
            d = node_directions[i]
            if i == 0:
                genes = (
                    self.get_gene_mer_genes(node)
                    if d == 1
                    else self.get_reverse_gene_mer_genes(node)
                )
                annotations += genes[:-1]
            if d:
                genes = (
                    self.get_gene_mer_genes(node)
                    if d == 1
                    else self.get_reverse_gene_mer_genes(node)
                )
                annotations.append(genes[-1])
        assert None not in annotations
        return annotations

    # ------------------------------------------------------------ junk reads

    def remove_junk_reads(self, error_rate):
        """Drop reads with more than (1 - error_rate) of their nodes filtered
        (construct_graph.py:1398-1420)."""
        new_reads, new_positions = {}, {}
        rejected, rejected_positions = {}, {}
        for rid, nodes in self._readNodes.items():
            allowed = round(len(nodes) * (1 - error_rate))
            n_filtered = sum(1 for n in nodes if n is None)
            if n_filtered <= allowed:
                new_reads[rid] = self._reads[rid]
                new_positions[rid] = self._genePositions[rid]
            else:
                rejected[rid] = self._reads[rid]
                rejected_positions[rid] = self._genePositions[rid]
        return new_reads, new_positions, rejected, rejected_positions

    def get_valid_reads_only(self):
        return {
            rid: genes
            for rid, genes in self._reads.items()
            if rid not in self._readsToCorrect
        }

    # ----------------------------------------------------------- path search

    def new_find_paths_between_nodes(self, start_hash, end_hash, distance, direction):
        """Bounded DFS for all simple paths from (start, direction) to
        end_hash within `distance` nodes (construct_graph.py:2292-2342).
        Iterative implementation."""
        results = []
        # stack entries: (node_hash, direction, path, seen)
        stack = [(start_hash, direction, [(start_hash, direction)], {start_hash})]
        while stack:
            h, d, path, seen = stack.pop()
            if end_hash is not None:
                if h == end_hash and len(path) <= distance:
                    results.append(path)
                    continue
            else:
                if len(path) - 1 == distance:
                    results.append(path)
                    continue
            if len(path) - 1 > distance:
                continue
            node = self._nodes.get(h)
            if node is None:
                continue
            edge_keys = node.fwd_edges if d == 1 else node.bwd_edges if d == -1 else []
            for key in edge_keys:
                edge = self._edges[key]
                nxt = edge.tgt
                if nxt in seen:
                    continue
                stack.append(
                    (nxt, edge.tgt_dir, path + [(nxt, edge.tgt_dir)], seen | {nxt})
                )
        return results

    # -------------------------------------------------------- tip trimming

    def remove_short_linear_paths(self, min_length, sample_genesOfInterest=()):
        """Dead-end/tip trimming (construct_graph.py:679-720)."""
        paths_to_remove: dict = {}
        mean_cov = self.get_mean_node_coverage() if self._nodes else 0.0
        for node in self.all_nodes():
            if self.get_degree(node) == 1:
                path = self.get_linear_path_for_node(node)
                if 0 < len(path) < min_length:
                    if all(
                        self._nodes[h].coverage > mean_cov * 1.5 for h in path
                    ):
                        continue  # tandem-repeat guard
                    paths_to_remove.setdefault(node.component, []).append(path)
        amr_nodes = self.get_AMR_nodes(sample_genesOfInterest)
        removed = set()
        for component, paths in paths_to_remove.items():
            if component is not None:
                comp_nodes = {n.hash for n in self.get_nodes_in_component(component)}
            else:
                comp_nodes = set()
            for path in paths:
                if component is not None and len(
                    comp_nodes.intersection(path)
                ) == len(comp_nodes):
                    continue  # never delete a whole component
                for h in path:
                    if h in amr_nodes or h in removed:
                        continue
                    self.remove_node(self._nodes[h])
                    removed.add(h)
        return list(removed)

    # --------------------------------------------------------------- output

    def assign_Id_to_nodes(self):
        for i, node in enumerate(self._nodes.values()):
            node.node_id = i

    def generate_gml(self, output_file, geneMerSize, min_node_coverage, min_edge_coverage):
        """GML export (construct_graph.py:873-909)."""
        import os

        parts = ["graph\t[", "multigraph 1"]
        self.assign_Id_to_nodes()
        for node in self.all_nodes():
            entry = "\tnode\t[\n"
            entry += f"\t\tid\t{node.node_id}\n"
            entry += f'\t\tlabel\t"{self.get_gene_mer_label(node)}"\n'
            entry += f"\t\tcoverage\t{node.coverage}\n"
            if node.component:
                entry += f"\t\tcomponent\t{node.component}\n"
            entry += '\t\treads\t"' + ",".join(node.reads) + '"\n'
            if node.color:
                entry += f'\t\tcolor\t"{node.color}"\n'
            entry += "\t]"
            parts.append(entry)
            for edge in self.get_forward_edges(node) + self.get_backward_edges(node):
                if edge.coverage == 0:
                    continue
                tgt = self._nodes[edge.tgt]
                e = "\tedge\t[\n"
                e += f"\t\tsource\t{node.node_id}\n"
                e += f"\t\ttarget\t{tgt.node_id}\n"
                e += f"\t\tsource_direction\t{edge.src_dir}\n"
                e += f"\t\ttarget_direction\t{edge.tgt_dir}\n"
                e += f"\t\tweight\t{edge.coverage}\n"
                e += "\t]"
                parts.append(e)
        parts.append("]")
        out = ".".join(
            [output_file, str(geneMerSize), str(min_node_coverage), str(min_edge_coverage)]
        )
        d = os.path.dirname(out)
        if d and not os.path.exists(d):
            os.makedirs(d, exist_ok=True)
        with open(out + ".gml", "w") as fh:
            fh.write("\n".join(parts))
        return parts

    def color_node(self, node: Node, amr_genes):
        names = [self.vocab.name_of(abs(int(t))) for t in node.tokens]
        if not any(g in amr_genes for g in names):
            node.color = 0
        elif self.get_degree(node) <= 2:
            node.color = 1
        else:
            node.color = 2

    # ---------------------------------------------- subgraph path utilities

    def create_adjacency_matrix(self, nodeHashesOfInterest):
        """Dense 0/1 adjacency over a node subset
        (construct_graph.py:974-983)."""
        size = len(nodeHashesOfInterest)
        matrix = np.zeros((size, size), dtype=int)
        node_index = {n: i for i, n in enumerate(nodeHashesOfInterest)}
        for h in nodeHashesOfInterest:
            node = self._nodes[h]
            for nb in self.get_all_neighbor_hashes(node):
                if nb in node_index:
                    matrix[node_index[h], node_index[nb]] = 1
        return matrix

    def find_paths(self, matrix, start, end, path=None):
        """All simple paths in a dense adjacency matrix
        (construct_graph.py:985-995), iteratively."""
        results = []
        stack = [[start]]
        while stack:
            p = stack.pop()
            if p[-1] == end:
                results.append(p)
                continue
            for neighbor, connected in enumerate(matrix[p[-1]]):
                if connected and neighbor not in p:
                    stack.append(p + [neighbor])
        return results

    def all_paths_for_subgraph(self, nodeHashesOfInterest, anchor_nodes):
        """(construct_graph.py:997-1021)"""
        matrix = self.create_adjacency_matrix(nodeHashesOfInterest)
        paths: dict = {}
        for i in range(len(nodeHashesOfInterest)):
            for j in range(len(nodeHashesOfInterest)):
                si, sj = sorted([i, j])
                pair = (nodeHashesOfInterest[si], nodeHashesOfInterest[sj])
                if (
                    i != j
                    and pair not in paths
                    and nodeHashesOfInterest[i] in anchor_nodes
                    and nodeHashesOfInterest[j] in anchor_nodes
                ):
                    found = [
                        [nodeHashesOfInterest[x] for x in p]
                        for p in self.find_paths(matrix, si, sj)
                    ]
                    if found:
                        paths[pair] = found
        return paths

    def get_anchors_of_interest(self, nodeHashesOfInterest):
        """Anchor/junction split of a node subset
        (construct_graph.py:1023-1043)."""
        nodeAnchors, nodeJunctions = set(), set()
        subset = set(nodeHashesOfInterest)
        for h in nodeHashesOfInterest:
            node = self._nodes[h]
            fwd_in = [n for n in self.get_forward_neighbors(node) if n.hash in subset]
            bwd_in = [n for n in self.get_backward_neighbors(node) if n.hash in subset]
            if len(bwd_in) == 0 or len(fwd_in) == 0:
                nodeAnchors.add(h)
            if (
                len(self.get_backward_neighbors(node)) > 1
                or len(self.get_forward_neighbors(node)) > 1
            ):
                nodeJunctions.add(h)
        return nodeAnchors, nodeJunctions

    # ------------------------------------------- read-intersection trimming

    def make_intersection_matrix(self):
        """Pairwise read-set intersection counts over all nodes
        (construct_graph.py:2571-2589), vectorized via a node x read
        incidence matrix."""
        node_hashes = list(self._nodes.keys())
        read_ids = {r: i for i, r in enumerate(self._reads.keys())}
        inc = np.zeros((len(node_hashes), len(read_ids)), dtype=np.int32)
        for i, h in enumerate(node_hashes):
            for r in self._nodes[h].reads:
                if r in read_ids:
                    inc[i, read_ids[r]] = 1
        matrix = inc @ inc.T
        return matrix.tolist(), node_hashes

    def trim_fringe_nodes(self, number_of_intersecting_reads, intersection_matrix, node_hashes):
        """Remove nodes whose read overlap with every node is below the
        threshold (construct_graph.py:2618-2627)."""
        doomed = []
        for i, h in enumerate(node_hashes):
            if all(v < number_of_intersecting_reads for v in intersection_matrix[i]):
                doomed.append(self._nodes[h])
        for node in doomed:
            self.remove_node(node)
        return self

    def get_node_with_highest_subthreshold_connections(self, matrix, threshold):
        """(construct_graph.py:2591-2602)"""
        highest = -1
        node_index = None
        for i, row in enumerate(matrix):
            if not np.any(np.isnan(row)):
                count = int(np.sum(np.asarray(row) < threshold))
                if count > highest:
                    highest = count
                    node_index = i
        return node_index

    def filter_nodes_by_intersection(self, matrix, node_hashes, threshold=5):
        """(construct_graph.py:2604-2616)"""
        matrix = np.array(matrix, dtype=float)
        while True:
            lowest = self.get_node_with_highest_subthreshold_connections(
                matrix, threshold
            )
            if lowest is None:
                break
            matrix[lowest, :] = np.nan
            matrix[:, lowest] = np.nan
        return

    # -------------------------------------- sketch-based cluster merging

    def new_get_minhashes_for_paths(self, pathsOfInterest, fastq_dict):
        """Per-path read-subsequence sketches (construct_graph.py:2457-2472)."""
        from amira_tpu.sketch import MinHash

        path_minhashes = {}
        for path in pathsOfInterest:
            mh = MinHash(ksize=9, scaled=1)
            for read_id in pathsOfInterest[path]:
                read = "_".join(read_id.split("_")[:-2])
                start = int(read_id.split("_")[-2])
                end = int(read_id.split("_")[-1])
                mh.add_sequence(
                    fastq_dict[read]["sequence"][start : end + 1]
                )
            path_minhashes[path] = mh
        return path_minhashes

    def assess_connectivity(self, pathsOfInterest, minhash_for_paths, threshold):
        """(construct_graph.py:2515-2533)"""
        cluster_pairs: dict = {}
        keys = list(pathsOfInterest.keys())
        for i, p1 in enumerate(keys):
            cluster_pairs.setdefault(p1, set())
            for j in range(i + 1, len(keys)):
                p2 = keys[j]
                containment = max(
                    minhash_for_paths[p1].contained_by(minhash_for_paths[p2]),
                    minhash_for_paths[p2].contained_by(minhash_for_paths[p1]),
                )
                if containment >= threshold:
                    cluster_pairs[p1].add(p2)
                    cluster_pairs.setdefault(p2, set()).add(p1)
        return cluster_pairs

    def cluster_paths(self, clusters):
        """Union-find over the connectivity dict
        (construct_graph.py:2474-2513)."""
        parent: dict = {}

        def find(x):
            root = x
            while parent[root] != root:
                root = parent[root]
            while parent[x] != root:  # path compression
                parent[x], x = root, parent[x]
            return root

        for node in clusters:
            parent.setdefault(node, node)
            for connected in clusters[node]:
                parent.setdefault(connected, connected)
        for node in clusters:
            for connected in clusters[node]:
                ra, rb = find(node), find(connected)
                if ra != rb:
                    parent[rb] = ra
        result: dict = {}
        for node in parent:
            result.setdefault(find(node), set()).add(node)
        return result

    def merge_read_clusters(self, merged_paths, pathsOfInterest):
        merged: dict = {}
        for cluster in merged_paths:
            merged[cluster] = set()
            for path in merged_paths[cluster]:
                merged[cluster].update(pathsOfInterest[path])
        return merged

    def new_merge_clusters(self, pathsOfInterest, fastq_dict):
        """Merge path clusters whose sketches are >= 0.85 contained
        (construct_graph.py:2544-2563)."""
        minhash_for_paths = self.new_get_minhashes_for_paths(
            pathsOfInterest, fastq_dict
        )
        cluster_pairs = self.assess_connectivity(
            pathsOfInterest, minhash_for_paths, 0.85
        )
        merged_paths = self.cluster_paths(cluster_pairs)
        return self.merge_read_clusters(merged_paths, pathsOfInterest)

    # ------------------------------------------------------- AMR-read trim

    def remove_non_AMR_associated_nodes(self, genesOfInterest):
        """Keep only nodes sharing reads with AMR-containing nodes
        (construct_graph.py:2941-2959)."""
        reads_of_interest = set()
        for gene in genesOfInterest:
            for node in self.get_nodes_containing(gene):
                reads_of_interest.update(node.reads)
        doomed = [
            n
            for n in self._nodes.values()
            if not reads_of_interest.intersection(n._read_set)
        ]
        for node in doomed:
            self.remove_node(node)

    # ----------------------------------------------- delegated algorithms

    def correct_reads(self, fastq_data):
        from amira_tpu.correct import correct_reads

        return correct_reads(self, fastq_data)

    def correct_low_coverage_paths(
        self,
        fastq_data,
        genesOfInterest,
        cores,
        min_path_coverage,
        components_to_skip,
        use_minimizers=False,
    ):
        from amira_tpu.bubbles import correct_low_coverage_paths

        if self.is_lazy:
            # table-backed sweep: no Node/Edge materialization (parity with
            # the object path pinned by tests/test_bubble_view.py)
            from amira_tpu.bubble_view import BubbleView

            return correct_low_coverage_paths(
                BubbleView(self),
                fastq_data,
                genesOfInterest,
                cores,
                min_path_coverage,
                components_to_skip,
                use_minimizers,
            )
        return correct_low_coverage_paths(
            self,
            fastq_data,
            genesOfInterest,
            cores,
            min_path_coverage,
            components_to_skip,
            use_minimizers,
        )

    def assign_reads_to_genes(
        self, listOfGenes, cores=1, allele_counts=None, mean_node_coverage=None, path_threshold=5
    ):
        from amira_tpu.cluster import assign_reads_to_genes

        return assign_reads_to_genes(
            self, listOfGenes, cores, allele_counts or {}, mean_node_coverage, path_threshold
        )

    def get_unitigs_in_graph(self, outfile):
        unitigs = set()
        for node in self.all_nodes():
            if len(self.get_all_neighbors(node)) > 2:
                continue
            path = self.get_linear_path_for_node(node, True)
            path = sorted([path, list(reversed(path))])[0]
            try:
                path_genes = self.get_genes_in_unitig(path)
            except (ValueError, AssertionError):
                continue
            canonical = sorted([path_genes, self.reverse_list_of_genes(path_genes)])[0]
            unitigs.add((tuple(canonical), len(self.collect_reads_in_path(path))))
        with open(outfile, "w") as f:
            f.write("\n".join(f"{','.join(u[0])}\t{u[1]}" for u in unitigs))



"""Canonical DNA k-mer counting, histogramming and querying on device.

Replaces the reference's Jellyfish subprocesses (result_utils.py:1050-1141:
`jellyfish count -m 15 -C`, `histo`, `query`) with a JAX sort/segment
pipeline: 2-bit-packed canonical k-mers (k=15 fits 30 bits -> uint32),
device-wide sort, run-length extraction for counts, and searchsorted for
queries. Copy-number estimation math (Poisson-mixture error cutoff, smoothed
histogram peak) is ported from result_utils.py:975-1022.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from amira_tpu.sketch import encode_dna

_SENTINEL = np.uint8(255)


def _concat_codes(seqs: list[str]) -> np.ndarray:
    """Concatenate 2-bit base codes with sentinel separators so k-mer windows
    never span two sequences. One C-speed join + LUT pass — the per-read
    append/concatenate loop cost tens of seconds on gigabase read sets."""
    seqs = list(seqs)
    if not seqs:
        return np.zeros(0, dtype=np.uint8)
    # "\n" is not ACGT, so the LUT maps it to the 255 sentinel
    return encode_dna("\n".join(seqs) + "\n")


@partial(jax.jit, static_argnames=("k",))
def _kmer_codes_kernel(codes, k: int):
    """Canonical k-mer code for every window; invalid windows -> 2^(2k).

    codes: (N,) uint8 base codes (255 = invalid/separator).
    Returns (N - k + 1,) uint32 canonical codes, with invalid windows mapped
    to the (out-of-range) value 4**k, so a stable sort pushes them to the end.
    """
    n = codes.shape[0] - k + 1
    b = codes.astype(jnp.uint32)
    fwd = jnp.zeros(n, dtype=jnp.uint32)
    rc = jnp.zeros(n, dtype=jnp.uint32)
    valid = jnp.ones(n, dtype=bool)
    for j in range(k):
        bj = jax.lax.dynamic_slice_in_dim(b, j, n)
        valid = valid & (bj != 255)
        fwd = (fwd << 2) | (bj & 3)
        rc = rc | (((3 - bj) & 3) << (2 * j))
    canon = jnp.minimum(fwd, rc)
    return jnp.where(valid, canon, jnp.uint32(4**k))


def _pow2_bucket(n: int, minimum: int) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@partial(jax.jit, static_argnames=("k",))
def _count_kernel(codes, k: int):
    """Sorted window codes + run boundaries + per-slot run counts."""
    wc = _kmer_codes_kernel(codes, k)  # invalid -> 4**k (sorts last)
    sc = jnp.sort(wc)
    valid = sc < jnp.uint32(4**k)
    boundary = valid & jnp.concatenate(
        [jnp.ones((1,), bool), sc[1:] != sc[:-1]]
    )
    run_id = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    N = sc.shape[0]
    seg = jnp.where(valid, run_id, N).astype(jnp.int32)
    counts = jax.ops.segment_sum(
        valid.astype(jnp.int32), seg, num_segments=N + 1
    )[seg]
    return sc, boundary, counts


@partial(jax.jit, static_argnames=("C",))
def _compact_count_kernel(sorted_codes, boundary, run_counts, C: int):
    run_id = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    idx = jnp.where(boundary, run_id, C)
    kmers = jnp.zeros((C + 1,), jnp.uint32).at[idx].set(
        jnp.where(boundary, sorted_codes, 0)
    )[:C]
    counts = jnp.zeros((C + 1,), jnp.uint32).at[idx].set(
        jnp.where(boundary, run_counts, 0).astype(jnp.uint32)
    )[:C]
    return kmers, counts


def _host_canonical_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """Valid canonical window codes, vectorized numpy (same values as
    _kmer_codes_kernel, invalid windows dropped).

    Window codes are built by length doubling — f_{w+v}[i] = f_w[i] << 2v
    | f_v[i+w] — so k=15 takes ~7 O(N) passes instead of 15 (this runs
    over the ENTIRE read set for copy-number estimation)."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint32)
    bad = codes >= 4
    cs = np.zeros(len(codes) + 1, np.int64)
    np.cumsum(bad, out=cs[1:])
    valid = (cs[k:] - cs[:-k]) == 0
    cc = np.where(bad, 0, codes).astype(np.uint32)
    rc1 = (np.uint32(3) - cc) & np.uint32(3)

    def window_codes(base):
        # powers[p] = codes of windows of length 2^p (truncated arrays)
        pw, plen = [base], [1]
        while plen[-1] * 2 <= k:
            w = plen[-1]
            prev = pw[-1]
            pw.append((prev[: len(prev) - w] << np.uint32(2 * w)) | prev[w:])
            plen.append(2 * w)
        acc, alen = None, 0
        for p in range(len(pw) - 1, -1, -1):
            if alen + plen[p] <= k:
                piece = pw[p]
                if acc is None:
                    acc, alen = piece, plen[p]
                else:
                    acc = (
                        acc[: len(acc) - plen[p]] << np.uint32(2 * plen[p])
                    ) | piece[alen:]
                    alen += plen[p]
        return acc[:n]

    fwd = window_codes(cc)
    # rc code of window [i, i+k): sum_j (3-c[i+j]) << 2j = the forward
    # composition of rc1 with the shift roles swapped — compute via the
    # same doubling on rc1 but composing in reversed significance
    rcp, rlen = [rc1], [1]
    while rlen[-1] * 2 <= k:
        w = rlen[-1]
        prev = rcp[-1]
        # reversed significance: later positions take HIGHER bits
        rcp.append(prev[: len(prev) - w] | (prev[w:] << np.uint32(2 * w)))
        rlen.append(2 * w)
    acc, alen = None, 0
    for p in range(len(rcp) - 1, -1, -1):
        if alen + rlen[p] <= k:
            piece = rcp[p]
            if acc is None:
                acc, alen = piece, rlen[p]
            else:
                acc = acc[: len(acc) - rlen[p]] | (
                    piece[alen:] << np.uint32(2 * alen)
                )
                alen += rlen[p]
    rc = acc[:n]
    return np.minimum(fwd, rc)[valid]


# above this many base codes, the per-window device sort path's whole-buffer
# transfer and XLA sort lose to either the host numpy sort or the dense
# device counter; identical counts every way
_HOST_SORT_THRESHOLD = 1 << 25
_HOST_COUNT_CHUNK = 1 << 27
# above this many codes the dense-bincount counter (8 GB table for k=15)
# pays for itself vs per-chunk sorting
_HOST_BINCOUNT_MIN = 1 << 28


def _use_host_count(n: int) -> bool:
    if n > _HOST_SORT_THRESHOLD:
        return True
    return jax.devices()[0].platform == "cpu" and n > (1 << 20)


# ------------------------------------------- dense device counter (gigabase)
#
# The jellyfish-replacement path for large read sets: a dense (4^k + 1)-bin
# uint32 count table resident in device memory (4 GiB at k=15), filled by
# chunk-streamed scatter-adds of canonical window codes. The table never
# crosses back to the host: histogramming (one scatter-add bincount over the
# bin values), the Poisson-cutoff refilter (one elementwise pass) and
# per-read-set queries (gathers) all run on device.
# Replaces `jellyfish count/histo/query` (result_utils.py:1050-1141).

_DENSE_CHUNK = 1 << 26  # codes per streamed chunk (one compiled shape)
_DENSE_MIN_CODES = 1 << 24  # smaller inputs take the sorted device path
_HISTO_CAP = 1 << 20  # count-histogram bins; counts past this resolve via top_k


def _pack_codes_2bit(codes: np.ndarray):
    """Host: pack base codes 16-per-uint32 plus a little-endian invalid
    bitmask (separators / non-ACGT), so a chunk transfers at 0.375 B/code.
    Contiguous (N/16, 16) shift + reduce — the strided c[j::16] loop read
    the whole buffer 16 times at stride 16 and dominated the pack."""
    import sys as _sys

    assert _sys.byteorder == "little"
    bad = codes > 3
    # bad positions carry garbage 2-bit values; the bitmask invalidates
    # every window touching them, so masking the VALUE is unnecessary
    c = codes & np.uint8(3)
    pad = (-len(c)) % 16
    if pad:
        c = np.concatenate([c, np.zeros(pad, np.uint8)])
        bad = np.concatenate([bad, np.ones(pad, bool)])
    shifts8 = np.array([0, 2, 4, 6], np.uint8)
    by = np.bitwise_or.reduce(c.reshape(-1, 4) << shifts8[None, :], axis=1)
    words = by.astype(np.uint8).view(np.uint32)
    return words, np.packbits(bad, bitorder="little")


@partial(jax.jit, static_argnames=("k",), donate_argnums=(0,))
def _dense_count_chunk(table, packed_words, bad_bytes, k: int):
    """Unpack one chunk, form canonical window codes, scatter-add into the
    donated dense table. Invalid windows land in the extra slot 4^k."""
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
    return table.at[idx].add(jnp.uint32(1))


@partial(jax.jit, static_argnames=("CAP",))
def _dense_histo_bincount(table, CAP: int):
    """count -> #bins histogram of the dense table via ONE scatter-add into
    CAP bins (peak memory = table + one int32 temp; the earlier sort-based
    variant needed ~17 GB of temporaries at k=15 and OOM'd a 16 GB chip).
    Counts >= CAP (vanishingly rare) are tallied separately and resolved
    exactly by the host via top_k."""
    vals = table[:-1]
    clipped = jnp.minimum(vals, jnp.uint32(CAP - 1)).astype(jnp.int32)
    bc = jnp.zeros(CAP, jnp.int32).at[clipped].add(jnp.int32(1))
    n_over = jnp.sum((vals >= jnp.uint32(CAP)).astype(jnp.int32))
    return bc, n_over


@partial(jax.jit, static_argnames=("K",))
def _dense_tail_topk(table, K: int):
    return jax.lax.top_k(table[:-1], K)[0]


@jax.jit
def _dense_filter_kernel(table, cutoff):
    """jellyfish-recount-with--L equivalent: zero every bin below cutoff
    (the invalid-slot tail bin is zeroed too; it is never queried)."""
    return jnp.where(table >= cutoff, table, jnp.uint32(0)).at[-1].set(0)


@partial(jax.jit, static_argnames=("k",))
def _dense_query_median(table, packed_words, bad_bytes, k: int):
    """Median of the NONZERO table counts over every valid k-mer window of
    a 2-bit-packed query stream — windowing, gather, sort and median all on
    device, so per-path depth queries ship 0.375 B/code up and one scalar
    back.
    Returns (median*2 as uint32 sum of the two middle counts, nnz)."""
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
    counts = jnp.where(valid, table[jnp.where(valid, canon, 0)], 0)
    sc = jnp.sort(counts)  # zeros (absent/invalid) sort first
    N = sc.shape[0]
    z = jnp.sum((sc == 0).astype(jnp.int32))
    nnz = N - z
    lo = sc[jnp.clip(z + (nnz - 1) // 2, 0, N - 1)]
    hi = sc[jnp.clip(z + nnz // 2, 0, N - 1)]
    return lo + hi, nnz


def _use_dense_device_count(n_codes: int, k: int) -> bool:
    """The dense device counter on an accelerator whenever its table fits
    (4^k + 1 uint32 bins) and the input is large enough to pay for it; the
    CPU backend keeps the host counter. Every path gives identical counts.
    Override with AMIRA_TPU_KMER_BACKEND=host|device."""
    import os

    env = os.environ.get("AMIRA_TPU_KMER_BACKEND")
    if env == "host":
        return False
    if jax.devices()[0].platform == "cpu":
        return env == "device"
    if 4**k + 1 > (1 << 31):
        return False  # table would not fit device memory
    return env == "device" or n_codes >= _DENSE_MIN_CODES


class KmerCounter:
    """Canonical k-mer count table over a read set (jellyfish equivalent)."""

    def __init__(self, k: int = 15):
        assert 2 * k <= 31, "k-mer must fit in an int32 code"
        self.k = k
        self.kmers: np.ndarray = np.zeros(0, dtype=np.uint32)
        self.counts: np.ndarray = np.zeros(0, dtype=np.int64)
        # dense device mode: the whole (4^k + 1)-bin table lives on device and
        # kmers/counts above stay empty (histo/query route through it)
        self.dense = None

    @classmethod
    def _from_seqs_dense(cls, seqs, k: int, min_count: int):
        """Dense device counter fed by the native C packer: reads pack
        straight into fixed-size 2-bit chunk buffers (no gigabase host
        join + LUT + numpy bit-pack pass), and each chunk upload overlaps the
        next chunk's pack through JAX async dispatch. Table is
        bin-for-bin identical to _from_codes_dense: reads never span
        chunks and every inter-read gap carries an invalid sentinel."""
        from amira_tpu.native import load as _load_native

        native = _load_native()
        if native is None or not hasattr(native, "pack_dna_chunk"):
            return cls._from_codes_dense(_concat_codes(seqs), k, min_count)
        self = cls(k)
        table = jnp.zeros(4**k + 1, dtype=jnp.uint32)
        CH = _DENSE_CHUNK
        idx, off, n = 0, 0, len(seqs)
        while idx < n:
            words_b, bad_b, idx, off = native.pack_dna_chunk(
                seqs, idx, off, CH, k
            )
            words = np.frombuffer(words_b, np.uint32)
            bad = np.frombuffer(bad_b, np.uint8)
            table = _dense_count_chunk(
                table, jax.device_put(words), jax.device_put(bad), k
            )
        if min_count > 0:
            table = _dense_filter_kernel(table, jnp.uint32(min_count))
        self.dense = table
        return self

    @classmethod
    def _from_codes_dense(cls, codes: np.ndarray, k: int, min_count: int):
        """Dense device counter: chunk-streamed scatter-add (see module
        comment). Chunks split at separator boundaries so no window spans
        two chunks; the final short chunk pads with invalid positions."""
        self = cls(k)
        table = jnp.zeros(4**k + 1, dtype=jnp.uint32)
        CH = _DENSE_CHUNK
        n = len(codes)
        start = 0
        while start < n:
            end = min(start + CH, n)
            if end < n:
                seps = np.nonzero(codes[start:end] == _SENTINEL)[0]
                if len(seps):
                    end = start + int(seps[-1]) + 1
            chunk = codes[start:end]
            if end < n and codes[end - 1] != _SENTINEL:
                # a single >CH-code sequence forced a mid-sequence cut:
                # overlap the next chunk by k-1 codes so boundary-spanning
                # windows count exactly once
                next_start = end - (k - 1)
            else:
                next_start = end
            if len(chunk) < CH:
                chunk = np.concatenate(
                    [chunk, np.full(CH - len(chunk), _SENTINEL, np.uint8)]
                )
            words, bad = _pack_codes_2bit(chunk)
            table = _dense_count_chunk(
                table, jax.device_put(words), jax.device_put(bad), k
            )
            start = next_start
        if min_count > 0:
            table = _dense_filter_kernel(table, jnp.uint32(min_count))
        self.dense = table
        return self

    @classmethod
    def from_sequences(cls, seqs, k: int = 15, min_count: int = 0):
        self = cls(k)
        seqs = list(seqs)
        # the joined sentinel-separated stream is one code per base plus
        # one separator per read — known without building it
        n_codes = sum(len(s) for s in seqs) + len(seqs)
        if n_codes < k:
            return self
        if _use_dense_device_count(n_codes, k):
            return cls._from_seqs_dense(seqs, k, min_count)
        codes = _concat_codes(seqs)
        if len(codes) < k:
            return self
        if _use_host_count(len(codes)):
            # chunked: the doubling-code temporaries are ~10x the chunk
            # size, so bound the chunk (gigabase inputs would otherwise
            # need tens of GB); per-chunk unique tables merge by sorted
            # run-length sum. Chunks split at separator boundaries so no
            # window spans two chunks.
            CHUNK = _HOST_COUNT_CHUNK
            n = len(codes)
            use_bincount = n >= _HOST_BINCOUNT_MIN and 4**k <= 1 << 30
            table = np.zeros(4**k, dtype=np.int64) if use_bincount else None
            parts_k, parts_c = [], []
            start = 0
            while start < n:
                end = min(start + CHUNK, n)
                mid_sequence_cut = False
                if end < n:
                    # codes[end-1] may be mid-sequence: back up to the last
                    # separator so windows stay intact
                    seps = np.nonzero(codes[start:end] == _SENTINEL)[0]
                    if len(seps) == 0:
                        # a single >CHUNK-code sequence: cut anyway and
                        # overlap the next chunk by k-1 codes so
                        # boundary-spanning windows count exactly once
                        mid_sequence_cut = True
                    else:
                        end = start + int(seps[-1]) + 1
                wc = _host_canonical_codes(codes[start:end], k)
                if len(wc):
                    if use_bincount:
                        # gigabase inputs: one O(N) scatter into the dense
                        # 4^k table beats sorting every chunk (k <= 15 so
                        # the table is at most 2^30 bins); bincount WITHOUT
                        # minlength, added into a slice, avoids allocating
                        # a fresh full-size (8 GB at k=15) temp per chunk
                        bc = np.bincount(wc)
                        table[: len(bc)] += bc
                    else:
                        uk, uc = np.unique(wc, return_counts=True)
                        parts_k.append(uk)
                        parts_c.append(uc.astype(np.int64))
                start = end - (k - 1) if mid_sequence_cut else end
            if use_bincount:
                kmers = np.nonzero(table)[0].astype(np.uint32)
                counts = table[kmers.astype(np.int64)]
            elif not parts_k:
                return self
            elif len(parts_k) == 1:
                kmers, counts = parts_k[0], parts_c[0]
            else:
                allk = np.concatenate(parts_k)
                allc = np.concatenate(parts_c)
                order = np.argsort(allk, kind="stable")
                allk, allc = allk[order], allc[order]
                boundary = np.concatenate(
                    [[True], allk[1:] != allk[:-1]]
                )
                idx = np.nonzero(boundary)[0]
                kmers = allk[idx]
                sums = np.zeros(len(allk) + 1, np.int64)
                np.cumsum(allc, out=sums[1:])
                counts = sums[np.append(idx[1:], len(allk))] - sums[idx]
            if len(kmers) == 0:
                return self
            if min_count > 0:
                keep = counts >= min_count
                kmers, counts = kmers[keep], counts[keep]
            self.kmers, self.counts = kmers, counts
            return self
        # windowing + sort + run-length counting on device; only the compact
        # (distinct k-mer, count) table crosses back to the host
        n_pad = _pow2_bucket(len(codes), 1 << 16)
        if n_pad != len(codes):
            codes = np.concatenate(
                [codes, np.full(n_pad - len(codes), _SENTINEL, np.uint8)]
            )
        sorted_codes, boundary, run_counts = _count_kernel(codes, k)
        n_distinct = int(jnp.sum(boundary))
        if n_distinct == 0:
            return self
        C = _pow2_bucket(n_distinct, 1 << 12)
        kc, cc = _compact_count_kernel(sorted_codes, boundary, run_counts, C)
        kmers = np.asarray(kc)[:n_distinct]
        counts = np.asarray(cc)[:n_distinct].astype(np.int64)
        if min_count > 0:
            keep = counts >= min_count
            kmers, counts = kmers[keep], counts[keep]
        self.kmers, self.counts = kmers, counts
        return self

    def histo(self) -> dict[int, int]:
        """count -> number of distinct k-mers with that count
        (jellyfish histo)."""
        if self.dense is not None:
            CAP = _HISTO_CAP
            bc, n_over = _dense_histo_bincount(self.dense, CAP)
            bc = np.asarray(bc)
            nz = np.nonzero(bc)[0]
            out = {int(v): int(bc[v]) for v in nz if v > 0}
            n_over = int(n_over)
            if n_over:
                # exact tail: pull the largest counts (values >= CAP)
                K = 1 << max(int(np.ceil(np.log2(n_over))), 4)
                tail = np.asarray(_dense_tail_topk(self.dense, K))
                tail = tail[tail >= CAP]
                out.pop(CAP - 1, None)  # remove the clipped lump
                clipped_under = bc[CAP - 1] - n_over
                if clipped_under > 0:
                    out[CAP - 1] = int(clipped_under)
                vals, cnts = np.unique(tail, return_counts=True)
                for v, c in zip(vals, cnts):
                    out[int(v)] = out.get(int(v), 0) + int(c)
            return out
        if len(self.counts) == 0:
            return {}
        values, freqs = np.unique(self.counts, return_counts=True)
        return {int(v): int(f) for v, f in zip(values, freqs)}

    def query_sequences(self, seqs) -> np.ndarray:
        """Count of every k-mer occurrence of `seqs` in this table
        (jellyfish query): one entry per valid k-mer window, 0 when absent."""
        codes = _concat_codes(list(seqs))
        if len(codes) < self.k:
            return np.zeros(0, dtype=np.int64)
        if self.dense is not None:
            window_codes = _host_canonical_codes(codes, self.k)
            if len(window_codes) == 0:
                return np.zeros(0, dtype=np.int64)
            hits = self.dense[jnp.asarray(window_codes)]
            return np.asarray(hits).astype(np.int64)
        if _use_host_count(len(codes)):
            window_codes = _host_canonical_codes(codes, self.k)
            if len(window_codes) == 0 or len(self.kmers) == 0:
                return np.zeros(len(window_codes), dtype=np.int64)
            idx = np.searchsorted(self.kmers, window_codes)
            idx = np.clip(idx, 0, len(self.kmers) - 1)
            hit = self.kmers[idx] == window_codes
            return np.where(hit, self.counts[idx], 0)
        n_pad = _pow2_bucket(len(codes), 1 << 12)
        if n_pad != len(codes):
            codes = np.concatenate(
                [codes, np.full(n_pad - len(codes), _SENTINEL, np.uint8)]
            )
        window_codes = np.asarray(_kmer_codes_kernel(codes, self.k))
        window_codes = window_codes[window_codes < np.uint32(4**self.k)]
        if len(window_codes) == 0 or len(self.kmers) == 0:
            return np.zeros(len(window_codes), dtype=np.int64)
        idx = np.searchsorted(self.kmers, window_codes)
        idx = np.clip(idx, 0, len(self.kmers) - 1)
        hit = self.kmers[idx] == window_codes
        return np.where(hit, self.counts[idx], 0)


# ------------------------------------------------- copy-number estimation


def kmer_cutoff_estimation(kmer_counts: dict[int, int]) -> int:
    """Fit a 2-component Poisson mixture (error mu=1 vs signal mu=c) and
    return the smallest count where signal dominates
    (result_utils.py:975-1004)."""
    from scipy.optimize import minimize
    from scipy.stats import poisson

    i_values = np.array(list(kmer_counts.keys()))
    xi_values = np.array(list(kmer_counts.values()))

    def neg_log_likelihood(params):
        w, c = params
        if w < 0 or w > 1 or c <= 0:
            return np.inf
        error_prob = poisson.pmf(i_values, mu=1)
        real_prob = poisson.pmf(i_values, mu=c)
        mix = w * error_prob + (1 - w) * real_prob
        mix[mix == 0] = 1e-10
        return -np.sum(xi_values * np.log(mix))

    result = minimize(neg_log_likelihood, [0.1, 10], method="BFGS")
    w_opt, c_opt = result.x
    for i in i_values:
        if poisson.pmf(i, mu=c_opt) * (1 - w_opt) > poisson.pmf(i, mu=1) * w_opt:
            return int(i)
    return 0


def estimate_kmer_depth(kmer_counts: dict[int, int]) -> int:
    """Highest peak of the smoothed log k-mer count histogram
    (result_utils.py:1007-1022)."""
    from scipy.signal import find_peaks, savgol_filter

    x_values, y_values = zip(*sorted(kmer_counts.items()))
    log_counts = np.log(np.array(y_values) + 1)
    if len(log_counts) < 5:
        # too sparse to smooth: take the most frequent count directly
        return int(x_values[int(np.argmax(log_counts))])
    window_length = min(29, len(log_counts) // 2 * 2 + 1, len(log_counts))
    smoothed = savgol_filter(log_counts, window_length, min(3, window_length - 1))
    peak_indices, _ = find_peaks(smoothed)
    if len(peak_indices) == 0:
        peak_indices = np.array([int(np.argmax(smoothed))])
    max_peak = peak_indices[int(np.argmax(smoothed[peak_indices]))]
    return int(x_values[max_peak])


def estimate_overall_read_depth(sequences, k: int = 15):
    """Count -> cutoff-fit -> recount -> depth peak
    (result_utils.py:1050-1080). Returns (depth, filtered KmerCounter)."""
    full = KmerCounter.from_sequences(sequences, k)
    full_histo = full.histo()
    cutoff = kmer_cutoff_estimation(full_histo)
    # the recount with -L cutoff (result_utils.py:1070-1076) is exactly a
    # filter of the full table — no second windowing/sort pass needed
    filtered = KmerCounter(k)
    if full.dense is not None:
        filtered.dense = _dense_filter_kernel(
            full.dense, jnp.uint32(max(cutoff, 1))
        )
        # the filtered histogram is the full histogram above the cutoff —
        # no second table pass
        filtered_histo = {
            v: f for v, f in full_histo.items() if v >= max(cutoff, 1)
        }
    else:
        keep = full.counts >= max(cutoff, 1)
        filtered.kmers, filtered.counts = full.kmers[keep], full.counts[keep]
        filtered_histo = filtered.histo()
    depth = estimate_kmer_depth(filtered_histo)
    return depth, filtered


def estimate_depth_for_reads(counter: KmerCounter, sequences) -> float:
    """Median count of the reads' k-mers in the filtered table, dropping
    zero-count entries (result_utils.py:1037-1047, 1083-1086)."""
    if counter.dense is not None:
        sequences = list(sequences)
        n_codes = sum(len(s) for s in sequences) + len(sequences)
        if n_codes < counter.k:
            return 0.0
        n_pad = _pow2_bucket(n_codes, 1 << 12)
        words = bad = None
        from amira_tpu.native import load as _load_native

        native = _load_native()
        if native is not None and hasattr(native, "pack_dna_chunk"):
            wb, bb, idx, off = native.pack_dna_chunk(
                sequences, 0, 0, n_pad, counter.k
            )
            if idx == len(sequences):  # all reads fit in one buffer
                words = np.frombuffer(wb, np.uint32)
                bad = np.frombuffer(bb, np.uint8)
        if words is None:
            codes = _concat_codes(sequences)
            if n_pad != len(codes):
                codes = np.concatenate(
                    [codes, np.full(n_pad - len(codes), _SENTINEL, np.uint8)]
                )
            words, bad = _pack_codes_2bit(codes)
        med2, nnz = _dense_query_median(counter.dense, words, bad, counter.k)
        if int(nnz) == 0:
            return 0.0
        return float(int(med2)) / 2.0
    counts = counter.query_sequences(sequences)
    counts = counts[counts != 0]
    if len(counts) == 0:
        return 0.0
    return float(np.median(counts))

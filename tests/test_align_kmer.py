"""Alignment and k-mer kernel correctness."""

import os

import numpy as np
import pytest

from amira_tpu.ops.align import Aligner, reverse_complement
from amira_tpu.ops.kmer import (
    KmerCounter,
    estimate_depth_for_reads,
    estimate_overall_read_depth,
    kmer_cutoff_estimation,
)


def _random_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


def _mutate(rng, seq, sub_rate=0.05, indel_rate=0.02):
    out = []
    for ch in seq:
        r = rng.rand()
        if r < sub_rate:
            out.append(rng.choice([c for c in "ACGT" if c != ch]))
        elif r < sub_rate + indel_rate / 2:
            continue  # deletion
        elif r < sub_rate + indel_rate:
            out.append(ch)
            out.append(rng.choice(list("ACGT")))
        else:
            out.append(ch)
    return "".join(out)


def test_exact_match_alignment():
    rng = np.random.RandomState(1)
    ref = _random_seq(rng, 800)
    aligner = Aligner({"refA": ref}, band_width=64)
    hits = aligner.map_sequence(ref)
    assert "refA" in hits
    strand, aln = hits["refA"]
    assert strand == "+"
    assert aln.cigar == [("=", 800)]
    assert aln.q_start == 0 and aln.q_end == 800
    assert aln.r_start == 0 and aln.r_end == 800
    assert aln.identity() == 1.0


def test_reverse_strand_alignment():
    rng = np.random.RandomState(2)
    ref = _random_seq(rng, 600)
    aligner = Aligner({"r": ref}, band_width=64)
    hits = aligner.map_sequence(reverse_complement(ref))
    strand, aln = hits["r"]
    assert strand == "-"
    assert aln.matching_bases == 600


def test_noisy_read_alignment():
    """An ONT-like 7% error read aligns with high identity and near-full
    reference coverage."""
    rng = np.random.RandomState(3)
    ref = _random_seq(rng, 1500)
    read = _mutate(rng, ref)
    aligner = Aligner({"r": ref}, band_width=128)
    hits = aligner.map_sequence(read)
    strand, aln = hits["r"]
    assert strand == "+"
    assert aln.identity() > 0.9
    covered = aln.r_end - aln.r_start
    assert covered > 0.97 * len(ref)
    # CIGAR consumes exactly the aligned query and ref spans
    q_consumed = sum(n for op, n in aln.cigar if op in "=XI")
    r_consumed = sum(n for op, n in aln.cigar if op in "=XD")
    assert q_consumed == aln.q_end - aln.q_start
    assert r_consumed == aln.r_end - aln.r_start


def test_read_with_flanks_soft_clips():
    """A read = flank + gene + flank against the gene reference soft-clips
    the flanks (local alignment)."""
    rng = np.random.RandomState(4)
    gene = _random_seq(rng, 900)
    read = _random_seq(rng, 250) + gene + _random_seq(rng, 250)
    aligner = Aligner({"gene": gene}, band_width=64)
    _, aln = aligner.map_sequence(read)["gene"]
    assert aln.matching_bases == 900
    assert aln.q_start == 250 and aln.q_end == 1150
    assert aln.cigar_string().startswith("250S")
    assert aln.cigar_string().endswith("250S")


def test_best_reference_selection():
    rng = np.random.RandomState(5)
    base = _random_seq(rng, 1000)
    near = _mutate(rng, base, sub_rate=0.01, indel_rate=0)
    far = _mutate(rng, base, sub_rate=0.15, indel_rate=0.0)
    aligner = Aligner({"near": near, "far": far}, band_width=64)
    hits = aligner.map_sequence(base)
    assert hits["near"][1].matching_bases > hits["far"][1].matching_bases


def test_no_seeds_unmapped():
    rng = np.random.RandomState(6)
    aligner = Aligner({"r": _random_seq(rng, 500)}, band_width=64)
    hits = aligner.map_sequence(_random_seq(rng, 300))
    assert hits == {}


def test_kmer_counter_roundtrip():
    rng = np.random.RandomState(7)
    seq = _random_seq(rng, 2000)
    counter = KmerCounter.from_sequences([seq], k=15)
    # every k-mer of the sequence is present with count >= 1
    q = counter.query_sequences([seq])
    assert len(q) == 2000 - 15 + 1
    assert (q >= 1).all()
    # reverse complement maps to the same canonical table
    q_rc = counter.query_sequences([reverse_complement(seq)])
    assert (q_rc >= 1).all()
    # a foreign sequence has (near) zero hits
    foreign = _random_seq(np.random.RandomState(99), 2000)
    qf = counter.query_sequences([foreign])
    assert (qf == 0).mean() > 0.99


def test_kmer_counts_multiplicity():
    seq = "ACGTACGGTCCATGCAT"  # 17 bp -> 3 15-mers
    counter = KmerCounter.from_sequences([seq, seq, seq], k=15)
    assert sorted(counter.counts.tolist()) == [3, 3, 3]
    h = counter.histo()
    assert h == {3: 3}


def test_depth_estimation_pipeline():
    """30x coverage of a genome -> estimated k-mer depth ~= 30."""
    rng = np.random.RandomState(8)
    genome = _random_seq(rng, 3000)
    reads = [genome for _ in range(30)]
    # add error reads to form the error peak
    reads += [_mutate(rng, genome, 0.2, 0.1) for _ in range(2)]
    depth, counter = estimate_overall_read_depth(reads, k=15)
    assert 25 <= depth <= 35
    med = estimate_depth_for_reads(counter, [genome])
    assert 28 <= med <= 34


def test_cutoff_estimation():
    """Dense Poisson-mixture histogram: error peak at mu=1, signal at mu=30;
    the fitted cutoff falls between the peaks."""
    from scipy.stats import poisson

    histo = {}
    for c in range(1, 60):
        n = int(200000 * poisson.pmf(c, 1) + 10000 * poisson.pmf(c, 30))
        if n > 0:
            histo[c] = n
    cutoff = kmer_cutoff_estimation(histo)
    assert 2 <= cutoff <= 15


def test_kmer_host_path_matches_device_path():
    """The host numpy count path (used for large inputs, where the device
    transfer/sort loses) produces the identical (kmers, counts) table and
    query answers as the device sort pipeline."""
    import numpy as np

    from amira_tpu.ops import kmer as K

    rng = np.random.RandomState(9)
    bases = np.array(list("ACGTN"))
    seqs = [
        "".join(rng.choice(bases, size=int(rng.randint(10, 400)),
                           p=[0.24, 0.24, 0.24, 0.24, 0.04]))
        for _ in range(40)
    ]
    codes = K._concat_codes(seqs)
    assert not K._use_host_count(len(codes))  # small input -> device path
    dev = K.KmerCounter.from_sequences(seqs, 15)
    old = K._HOST_SORT_THRESHOLD
    try:
        K._HOST_SORT_THRESHOLD = 1  # force the host path
        host = K.KmerCounter.from_sequences(seqs, 15)
        q_host = host.query_sequences(seqs[:7])
    finally:
        K._HOST_SORT_THRESHOLD = old
    q_dev = dev.query_sequences(seqs[:7])
    assert np.array_equal(dev.kmers, host.kmers)
    assert np.array_equal(dev.counts, host.counts)
    assert np.array_equal(np.asarray(q_dev), np.asarray(q_host))


def test_kmer_host_chunked_count_matches_unchunked():
    """Separator-aligned chunking of the host count path merges per-chunk
    tables into the identical global table."""
    import numpy as np

    from amira_tpu.ops import kmer as K

    rng = np.random.RandomState(21)
    bases = np.array(list("ACGTN"))
    seqs = [
        "".join(rng.choice(bases, size=int(rng.randint(20, 900)),
                           p=[0.24, 0.24, 0.24, 0.24, 0.04]))
        for _ in range(80)
    ]
    old_t, old_c = K._HOST_SORT_THRESHOLD, K._HOST_COUNT_CHUNK
    try:
        K._HOST_SORT_THRESHOLD = 1
        K._HOST_COUNT_CHUNK = 1 << 30
        one = K.KmerCounter.from_sequences(seqs, 15)
        K._HOST_COUNT_CHUNK = 2048  # force many chunks
        many = K.KmerCounter.from_sequences(seqs, 15)
        K._HOST_COUNT_CHUNK = 2048
        many_min = K.KmerCounter.from_sequences(seqs, 15, min_count=3)
    finally:
        K._HOST_SORT_THRESHOLD, K._HOST_COUNT_CHUNK = old_t, old_c
    assert np.array_equal(one.kmers, many.kmers)
    assert np.array_equal(one.counts, many.counts)
    keep = one.counts >= 3
    assert np.array_equal(one.kmers[keep], many_min.kmers)


def test_kmer_dense_device_matches_host_gigabase_shaped():
    """The dense device counter (the gigabase jellyfish-replacement path:
    chunk-streamed 2-bit-packed transfer + scatter-add into a device-resident
    table) produces the identical table, histogram, query answers and
    cutoff-filtered depth pipeline as the host counter. Chunking is forced
    tiny, with one sequence far longer than a chunk, so the mid-sequence
    overlap cut and the separator-aligned cut both exercise."""
    import numpy as np

    from amira_tpu.ops import kmer as K

    rng = np.random.RandomState(17)
    bases = np.array(list("ACGTN"))
    k = 11
    seqs = [
        "".join(rng.choice(bases, size=int(rng.randint(30, 700)),
                           p=[0.24, 0.24, 0.24, 0.24, 0.04]))
        for _ in range(50)
    ]
    # a sequence several chunks long (forces mid-sequence overlap cuts)
    seqs.append("".join(rng.choice(bases[:4], size=9000)))
    # duplicate some sequences so counts go well above 1
    seqs += seqs[:20]

    old_chunk = K._DENSE_CHUNK
    old_env = os.environ.get("AMIRA_TPU_KMER_BACKEND")
    try:
        K._DENSE_CHUNK = 2048
        os.environ["AMIRA_TPU_KMER_BACKEND"] = "device"
        dense = K.KmerCounter.from_sequences(seqs, k)
        dense_min = K.KmerCounter.from_sequences(seqs, k, min_count=3)
        os.environ["AMIRA_TPU_KMER_BACKEND"] = "host"
        host = K.KmerCounter.from_sequences(seqs, k)
    finally:
        K._DENSE_CHUNK = old_chunk
        if old_env is None:
            os.environ.pop("AMIRA_TPU_KMER_BACKEND", None)
        else:
            os.environ["AMIRA_TPU_KMER_BACKEND"] = old_env

    assert dense.dense is not None and host.dense is None
    table = np.asarray(dense.dense)[:-1]
    kmers = np.nonzero(table)[0].astype(np.uint32)
    assert np.array_equal(kmers, host.kmers)
    assert np.array_equal(table[kmers.astype(np.int64)], host.counts)
    assert dense.histo() == host.histo()
    q_d = dense.query_sequences(seqs[:9])
    q_h = host.query_sequences(seqs[:9])
    assert np.array_equal(np.asarray(q_d), np.asarray(q_h))
    # min_count filter == host filter
    tmin = np.asarray(dense_min.dense)[:-1]
    kmin = np.nonzero(tmin)[0].astype(np.uint32)
    keep = host.counts >= 3
    assert np.array_equal(kmin, host.kmers[keep])


def test_kmer_dense_depth_pipeline_matches_host():
    """estimate_overall_read_depth through the dense device table (Poisson
    cutoff fit + device refilter + histogram peak) equals the host path."""
    import numpy as np

    from amira_tpu.ops import kmer as K

    rng = np.random.RandomState(5)
    bases = np.array(list("ACGT"))
    genome = "".join(rng.choice(bases, size=3000))
    reads = []
    for _ in range(120):
        s = rng.randint(0, 2500)
        ln = rng.randint(200, 500)
        seq = list(genome[s : s + ln])
        for j in range(0, len(seq), 61):
            seq[j] = str(rng.choice(bases))
        reads.append("".join(seq))
    old_env = os.environ.get("AMIRA_TPU_KMER_BACKEND")
    try:
        os.environ["AMIRA_TPU_KMER_BACKEND"] = "device"
        d_depth, d_counter = K.estimate_overall_read_depth(reads, 13)
        os.environ["AMIRA_TPU_KMER_BACKEND"] = "host"
        h_depth, h_counter = K.estimate_overall_read_depth(reads, 13)
    finally:
        if old_env is None:
            os.environ.pop("AMIRA_TPU_KMER_BACKEND", None)
        else:
            os.environ["AMIRA_TPU_KMER_BACKEND"] = old_env
    assert d_counter.dense is not None and h_counter.dense is None
    assert d_depth == h_depth
    d_reads = K.estimate_depth_for_reads(d_counter, reads[:25])
    h_reads = K.estimate_depth_for_reads(h_counter, reads[:25])
    assert d_reads == h_reads


def test_kmer_host_bincount_matches_sort_path():
    """The dense-bincount counter (large inputs) produces the same table as
    the chunked sort path."""
    import numpy as np

    from amira_tpu.ops import kmer as K

    rng = np.random.RandomState(33)
    bases = np.array(list("ACGTN"))
    seqs = [
        "".join(rng.choice(bases, size=int(rng.randint(30, 500)),
                           p=[0.24, 0.24, 0.24, 0.24, 0.04]))
        for _ in range(60)
    ]
    old = (K._HOST_SORT_THRESHOLD, K._HOST_COUNT_CHUNK, K._HOST_BINCOUNT_MIN)
    try:
        K._HOST_SORT_THRESHOLD = 1
        K._HOST_COUNT_CHUNK = 4096
        K._HOST_BINCOUNT_MIN = 1 << 60  # sort path
        srt = K.KmerCounter.from_sequences(seqs, 11)
        K._HOST_BINCOUNT_MIN = 1  # bincount path
        bc = K.KmerCounter.from_sequences(seqs, 11)
        bc_min = K.KmerCounter.from_sequences(seqs, 11, min_count=2)
    finally:
        (K._HOST_SORT_THRESHOLD, K._HOST_COUNT_CHUNK, K._HOST_BINCOUNT_MIN) = old
    assert np.array_equal(srt.kmers, bc.kmers)
    assert np.array_equal(srt.counts, bc.counts)
    keep = srt.counts >= 2
    assert np.array_equal(srt.kmers[keep], bc_min.kmers)


def test_kmer_dense_histo_tail_exact():
    """Counts at or past the histogram bin cap resolve exactly through the
    top_k tail path (and the clipped boundary bin stays correct)."""
    from amira_tpu.ops import kmer as K

    rng = np.random.RandomState(3)
    k = 9
    base = "".join(rng.choice(np.array(list("ACGT")), size=200))
    hot = base[:40]
    seqs = [base] + [hot] * 40  # some k-mers reach counts ~41
    old_cap = K._HISTO_CAP
    old_env = os.environ.get("AMIRA_TPU_KMER_BACKEND")
    try:
        K._HISTO_CAP = 16  # force the tail path
        os.environ["AMIRA_TPU_KMER_BACKEND"] = "device"
        dense = K.KmerCounter.from_sequences(seqs, k)
        os.environ["AMIRA_TPU_KMER_BACKEND"] = "host"
        K._HOST_SORT_THRESHOLD, old_t = 1, K._HOST_SORT_THRESHOLD
        try:
            host = K.KmerCounter.from_sequences(seqs, k)
        finally:
            K._HOST_SORT_THRESHOLD = old_t
    finally:
        K._HISTO_CAP = old_cap
        if old_env is None:
            os.environ.pop("AMIRA_TPU_KMER_BACKEND", None)
        else:
            os.environ["AMIRA_TPU_KMER_BACKEND"] = old_env
    assert dense.histo() == host.histo()
    assert max(host.histo()) >= 16  # the cap really was exceeded

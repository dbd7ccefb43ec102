"""Per-path assembly of the full reads assigned to each AMR gene copy.

The reference optionally shells out to Flye (`--assemble-paths`,
result_utils.py:1267-1288). Here assembly is a greedy overlap-layout-
consensus pipeline built on the in-process kernels:

  1. all-vs-all overlap detection by shared-k-mer diagonal voting (the
     minimap-style seeding already used by ops/align.py), both strands;
  2. a consistent orientation pass (BFS over the strongest overlaps);
  3. contained-read removal and greedy dovetail layout (best overlap first,
     one link per read end, union-find against cycles);
  4. per-contig draft construction from the voted offsets, then iterative
     polishing against the contig's reads with the device consensus kernel
     (ops/consensus.polish — batched banded SW on device).

Unlike the earlier backbone-polish stopgap this assembles past the longest
read: contigs span chains of dovetail overlaps. Repeat resolution beyond
greedy tie-breaking (Flye's repeat graph) is out of scope; tangled layouts
fall apart into shorter contigs rather than misassemble.
"""

from __future__ import annotations

import glob
import os
import sys
from collections import defaultdict

import numpy as np

from amira_tpu.io import parse_fastq, write_fasta
from amira_tpu.ops.align import (
    _forward_kmers,
    build_ref_seed_index,
    reverse_complement,
)
from amira_tpu.ops.consensus import polish
from amira_tpu.sketch import encode_dna

_SENTINEL = np.uint64(1) << np.uint64(62)


def _vote_overlaps(seqs: dict, k: int = 15, bin_width: int = 128,
                   min_votes: int = 6, max_occ: int = 16):
    """Candidate pairwise overlaps by shared-k-mer diagonal voting.

    Returns {(a, b, strand): (offset, votes)} with a < b in id order;
    strand '+' means b forward vs a forward, '-' means b forward vs rc(a).
    offset is the voted diagonal: pos_in_b - pos_in_a (a in the given
    orientation)."""
    ids = list(seqs)
    codes = {r: encode_dna(seqs[r]) for r in ids}
    # one concatenated seed index over all forward reads
    offsets, owner_bounds = [], []
    cat = []
    cursor = 0
    for r in ids:
        cat.append(codes[r])
        owner_bounds.append((cursor, cursor + len(codes[r])))
        cursor += len(codes[r]) + k  # gap so windows never span two reads
        cat.append(np.full(k, 255, dtype=np.uint8))
    cat = np.concatenate(cat) if cat else np.zeros(0, dtype=np.uint8)
    idx_kmers, idx_pos = build_ref_seed_index(cat, k=k)
    starts_arr = np.array([b[0] for b in owner_bounds], dtype=np.int64)
    ends_arr = np.array([b[1] for b in owner_bounds], dtype=np.int64)

    results: dict = {}
    for qi, r in enumerate(ids):
        for strand, qcodes in (
            ("+", codes[r]),
            ("-", encode_dna(reverse_complement(seqs[r]))),
        ):
            qk = _forward_kmers(qcodes, k)
            qpos = np.nonzero(qk != _SENTINEL)[0]
            qk = qk[qpos]
            if len(qk) == 0 or len(idx_kmers) == 0:
                continue
            lo = np.searchsorted(idx_kmers, qk, side="left")
            hi = np.searchsorted(idx_kmers, qk, side="right")
            counts = hi - lo
            keep = (counts > 0) & (counts <= max_occ)
            if not keep.any():
                continue
            reps = counts[keep]
            total = int(reps.sum())
            starts = np.repeat(lo[keep], reps)
            base = np.concatenate([[0], np.cumsum(reps)[:-1]])
            within = np.arange(total, dtype=np.int64) - np.repeat(base, reps)
            abs_pos = idx_pos[starts + within]
            tgt = np.searchsorted(ends_arr, abs_pos, side="right")
            rel_pos = abs_pos - starts_arr[tgt]
            diag = rel_pos - np.repeat(qpos[keep], reps)
            not_self = tgt != qi
            tgt, diag = tgt[not_self], diag[not_self]
            if len(tgt) == 0:
                continue
            # votes per (target, diagonal bin); merge the two adjacent bins
            # around the winner so indel drift across a long overlap doesn't
            # split the vote
            dbin = diag // bin_width
            key = tgt * np.int64(1 << 32) + (dbin & np.int64(0xFFFFFFFF))
            order = np.argsort(key, kind="stable")
            key_s, diag_s, tgt_s = key[order], diag[order], tgt[order]
            bounds = np.concatenate(
                [[0], np.nonzero(np.diff(key_s))[0] + 1, [len(key_s)]]
            )
            per_tgt: dict = {}
            for b0, b1 in zip(bounds[:-1], bounds[1:]):
                t = int(tgt_s[b0])
                if t == qi:
                    continue
                n = int(b1 - b0)
                best = per_tgt.get(t)
                if best is None or n > best[0]:
                    per_tgt[t] = (n, b0, b1)
            for t, (n, b0, b1) in per_tgt.items():
                # gather votes within +-1 bin of the winner
                center = diag_s[b0:b1]
                med = int(np.median(center))
                near = (tgt == t) & (np.abs(diag - med) <= bin_width)
                votes = int(near.sum())
                if votes < min_votes:
                    continue
                off = int(np.median(diag[near]))
                a, b = sorted((qi, t))
                if a == qi:
                    entry = (off, votes, strand)
                else:
                    # normalize to a < b: b-vs-a offset with a oriented.
                    # '+': symmetric, offset flips sign. '-': rc(q) vs t ==
                    # rc(t) vs q at mirrored offset; fold to t fwd vs rc(q).
                    if strand == "+":
                        entry = (-off, votes, "+")
                    else:
                        La = len(seqs[ids[a]])
                        Lq = len(seqs[r])
                        entry = (Lq - La + off, votes, "-")
                cur = results.get((a, b))
                if cur is None or votes > cur[1]:
                    results[(a, b)] = entry
    return ids, results


def _orient_reads(ids, overlaps):
    """Assign a consistent orientation per read: BFS over overlaps in
    descending vote order, flipping when the linking overlap is '-'."""
    adj = defaultdict(list)
    for (a, b), (off, votes, strand) in overlaps.items():
        adj[a].append((votes, b, strand))
        adj[b].append((votes, a, strand))
    orient = {}
    for seed in range(len(ids)):
        if seed in orient:
            continue
        orient[seed] = +1
        stack = [seed]
        while stack:
            u = stack.pop()
            for _votes, v, strand in sorted(adj[u], reverse=True):
                want = orient[u] * (1 if strand == "+" else -1)
                if v not in orient:
                    orient[v] = want
                    stack.append(v)
    return orient


def _offsets_oriented(seqs_o: dict, ids, k=15, bin_width=128, min_votes=6):
    """Second voting pass on consistently-oriented strings: forward-only
    offsets pos_in_b - pos_in_a per pair."""
    _ids, res = _vote_overlaps(
        {r: seqs_o[r] for r in ids}, k=k, bin_width=bin_width,
        min_votes=min_votes,
    )
    out = {}
    for (a, b), (off, votes, strand) in res.items():
        if strand != "+":
            continue  # inconsistent orientation remnant; drop
        out[(a, b)] = (off, votes)
    return out


def _map_offsets_to_contig(contig: str, seqs: dict, k: int = 15,
                           bin_width: int = 128, min_votes: int = 6):
    """Best diagonal placement of every sequence on `contig` (forward
    strand): {read_id: (offset, votes)}. The same shared-k-mer voting as
    _vote_overlaps with the contig as the only target."""
    ccodes = encode_dna(contig)
    idx_kmers, idx_pos = build_ref_seed_index(ccodes, k=k)
    out: dict = {}
    if len(idx_kmers) == 0:
        return out
    for r, s in seqs.items():
        qcodes = encode_dna(s)
        qk = _forward_kmers(qcodes, k)
        qpos = np.nonzero(qk != _SENTINEL)[0]
        qk = qk[qpos]
        if len(qk) == 0:
            continue
        lo = np.searchsorted(idx_kmers, qk, side="left")
        hi = np.searchsorted(idx_kmers, qk, side="right")
        counts = hi - lo
        keep = (counts > 0) & (counts <= 16)
        if not keep.any():
            continue
        reps = counts[keep]
        total = int(reps.sum())
        starts = np.repeat(lo[keep], reps)
        base = np.concatenate([[0], np.cumsum(reps)[:-1]])
        within = np.arange(total, dtype=np.int64) - np.repeat(base, reps)
        diag = idx_pos[starts + within] - np.repeat(qpos[keep], reps)
        dbin = diag // bin_width
        vals, cnts = np.unique(dbin, return_counts=True)
        best = int(vals[np.argmax(cnts)])
        near = np.abs(diag - best * bin_width) <= 2 * bin_width
        votes = int(near.sum())
        if votes < min_votes:
            continue
        out[r] = (int(np.median(diag[near])), votes)
    return out


def _junction_supported(
    contig: str, oriented: dict, j: int, k: int = 15, min_hits: int = 2,
):
    """True iff some single read contains >= min_hits of the k-mers that
    CROSS position j — spanning-read evidence for an appended junction.
    Merely placing a read across j is not enough: with interspersed
    repeats a read can vote-place onto the junction region through its
    repeat half alone while the other side mismatches, and a read may
    contain both sides' k-mers WITHOUT their adjacency (e.g. a genuine
    A|R-junction read has all the k-mers of a fabricated R|A junction but
    none crossing it). Only junction-crossing k-mers prove adjacency."""
    lo = max(j - (k - 1), 0)
    hi = min(j + (k - 1), len(contig))
    w = contig[lo:hi]
    cross = {w[i : i + k] for i in range(max(0, len(w) - k + 1))}
    if not cross:
        return True
    for s in oriented.values():
        hits = sum(1 for c in cross if c in s)
        if hits >= min_hits:
            return True
    return False


def _extend_contig_through_repeats(
    contig: str, members: list, oriented: dict, k: int = 15,
    min_votes: int = 6, min_overhang: int = 50, max_rounds: int = 40,
):
    """Iterative extension with read-path voting (the tractable half of
    Flye's repeat resolution, result_utils.py:1267-1288): a collapsed
    repeat leaves its copy-junction reads OVERHANGING the contig end —
    their prefix places at the repeat's end while their suffix carries the
    next genomic segment (for a tandem repeat: the repeat's start again).
    Each round re-maps every read to the contig and, when >= 2 reads agree
    on an overhang past an end, appends the longest agreeing overhang;
    repeated rounds walk the contig through the second copy and out. Ends
    when no supported overhang remains."""
    members = list(members)
    total_cap = len(contig) + sum(len(s) for s in oriented.values())
    right_dead = left_dead = False
    for _ in range(max_rounds):
        if len(contig) > total_cap:
            break
        placed = _map_offsets_to_contig(contig, oriented, k, min_votes=min_votes)
        grew = False
        # right end: reads whose tail hangs past the contig
        right = [] if right_dead else [
            (off + len(oriented[r]) - len(contig), r, off)
            for r, (off, _v) in placed.items()
            if off + len(oriented[r]) - len(contig) >= min_overhang
            and off < len(contig) - min_overhang
        ]
        if len(right) >= 2:
            # repeat-first: if the overhang tails themselves map back INSIDE
            # the contig, the genome re-enters sequence the contig already
            # holds — a collapsed repeat copy. Duplicate the contig suffix
            # from the voted re-entry point BEFORE taking any exit overhang
            # (the exit's evidence survives; the re-entry's would not).
            tails = {
                r: oriented[r][len(contig) - off :]
                for _o, r, off in right
            }
            tmap = _map_offsets_to_contig(
                contig, tails, k, min_votes=min_votes
            )
            reentry = [
                off2 for r, (off2, _v) in tmap.items()
                if 0 <= off2 < len(contig) - min_overhang
            ]
            j = len(contig)
            if len(reentry) >= 2:
                s = int(np.median(reentry))
                # the contig end usually stops a few bases SHORT of the
                # copy junction, so the duplication must route through the
                # tail: append the tail's unmatched prefix (read sequence,
                # carrying the true junction), then duplicate the contig
                # from where the tail's k-mers anchor. A bare contig[s:]
                # duplication splices the two sides a few bases off and
                # the crossing-k-mer validation below rightly rejects it.
                cand = None
                for _o2, r2, _f2 in right:
                    t = tails.get(r2, "")
                    for p in range(0, min(len(t) - k + 1, 3 * k)):
                        q = contig.find(
                            t[p : p + k],
                            max(s + p - 160, 0),
                            min(s + p + 160 + k, len(contig)),
                        )
                        if q != -1:
                            cand = contig + t[:p] + contig[q:]
                            break
                    if cand is not None:
                        break
                if cand is None:
                    cand = contig + contig[max(s, 0):]
            else:
                right.sort(reverse=True)
                _over, r, off = right[0]
                cand = contig + oriented[r][len(contig) - off :]
            if _junction_supported(cand, oriented, j, k):
                contig = cand
                for _o, rr, _f in right:
                    if rr not in members:
                        members.append(rr)
                grew = True
            else:
                right_dead = True
        # left end (mirror)
        left = [] if left_dead else [
            (-off, r, off)
            for r, (off, _v) in placed.items()
            if off <= -min_overhang
            and off + len(oriented[r]) >= min_overhang
        ]
        if len(left) >= 2:
            heads = {r: oriented[r][: -off] for _o, r, off in left}
            hmap = _map_offsets_to_contig(
                contig, heads, k, min_votes=min_votes
            )
            reentry = [
                off2 + len(heads[r])
                for r, (off2, _v) in hmap.items()
                if min_overhang <= off2 + len(heads[r]) <= len(contig)
            ]
            if len(reentry) >= 2:
                e = int(np.median(reentry))
                # mirror of the right end: route through the head's
                # unmatched suffix and anchor its trailing k-mers
                cand = None
                prefix_len = None
                for _o2, r2, _f2 in left:
                    h = heads.get(r2, "")
                    for p in range(0, min(len(h) - k + 1, 3 * k)):
                        sub = h[len(h) - k - p : len(h) - p]
                        q = contig.find(
                            sub,
                            max(e - p - 160 - k, 0),
                            min(e - p + 160, len(contig)),
                        )
                        if q != -1:
                            tail_h = h[len(h) - p :] if p else ""
                            cand = contig[: q + k] + tail_h + contig
                            prefix_len = q + k + p
                            break
                    if cand is not None:
                        break
                if cand is None:
                    prefix_len = min(e, len(contig))
                    cand = contig[:prefix_len] + contig
            else:
                left.sort(reverse=True)
                _over, r, off = left[0]
                prefix_len = -off
                cand = oriented[r][:-off] + contig
            if _junction_supported(cand, oriented, prefix_len, k):
                contig = cand
                for _o, rr, _f in left:
                    if rr not in members:
                        members.append(rr)
                grew = True
            else:
                left_dead = True
        if not grew:
            break
    return contig, members


def _merge_extended_contigs(contigs, k=15, min_votes=6, min_overlap=100):
    """Dovetail-join contigs whose extended ends now overlap (an extension
    that walked through a repeat reaches sequence another contig starts
    with). One greedy pass over contig pairs, containment-aware."""
    if len(contigs) <= 1:
        return contigs
    seqs = {i: c[0] for i, c in enumerate(contigs)}
    ids, votes = _vote_overlaps(seqs, k=k, min_votes=min_votes)
    merged_into: dict = {}
    out_seqs = dict(seqs)
    out_members = {i: list(contigs[i][1]) for i in range(len(contigs))}

    def root(i):
        while i in merged_into:
            i = merged_into[i]
        return i

    order = sorted(
        votes.items(), key=lambda kv: -kv[1][1]
    )
    for (a, b), (off, nv, strand) in order:
        if strand != "+":
            continue
        ra, rb = root(a), root(b)
        if ra == rb:
            continue
        sa, sb = out_seqs[ra], out_seqs[rb]
        place = _map_offsets_to_contig(sa, {0: sb}, k, min_votes=min_votes)
        if 0 not in place:
            place = _map_offsets_to_contig(sb, {0: sa}, k, min_votes=min_votes)
            if 0 not in place:
                continue
            ra, rb = rb, ra
            sa, sb = sb, sa
        off2, _v = place[0]
        olap = min(len(sa) - off2, len(sb)) - max(0, -off2)
        if olap < min_overlap:
            continue
        if off2 >= 0 and off2 + len(sb) <= len(sa):
            joined = sa  # contained
        elif off2 >= 0:
            joined = sa[:off2] + sb
        elif -off2 + len(sa) <= len(sb):
            joined = sb
        else:
            joined = sb[: -off2] + sa
        out_seqs[ra] = joined
        out_members[ra].extend(out_members.pop(rb))
        del out_seqs[rb]
        merged_into[rb] = ra
    return [(out_seqs[i], out_members[i]) for i in sorted(out_seqs)]


def assemble_reads(reads: dict, k: int = 15, min_votes: int = 6,
                   min_overlap: int = 100, polish_iterations: int = 3,
                   band_width: int = 512):
    """Greedy OLC assembly of {read_id: sequence}. Returns a list of
    (contig_sequence, [read ids]) sorted by length descending."""
    reads = {r: s for r, s in reads.items() if len(s) >= k}
    if not reads:
        return []
    ids, votes = _vote_overlaps(reads, k=k, min_votes=min_votes)
    orient = _orient_reads(ids, votes)
    oriented = {
        r: (reads[r] if orient.get(i, 1) > 0 else reverse_complement(reads[r]))
        for i, r in enumerate(ids)
    }
    pair_off = _offsets_oriented(oriented, ids, k=k, min_votes=min_votes)

    lens = {i: len(oriented[ids[i]]) for i in range(len(ids))}
    # ---- repeat multiplicity from overlap depth, computed BEFORE
    # containment: a two-copy collapsed repeat's interior reads carry ~2x
    # the median overlap coverage, so each such read may be PLACED that
    # many times during layout (the coverage half of Flye's repeat
    # resolution; result_utils.py:1267-1288)
    cov = np.zeros(len(ids))
    for (a, b), (off, nv) in pair_off.items():
        olap = min(lens[a], lens[b] - off) - max(0, -off)
        if olap > 0:
            cov[a] += olap
            cov[b] += olap
    depth = 1.0 + cov / np.array(
        [max(lens[i], 1) for i in range(len(ids))], dtype=float
    )
    med = float(np.median(depth)) if len(ids) else 1.0
    mult = {
        i: int(np.clip(np.round(depth[i] / max(med, 1e-9)), 1, 4))
        for i in range(len(ids))
    }

    # containment: b's span inside a (or vice versa) with slack. Reads in
    # repeat regions (mult >= 2) are EXEMPT: two staggered copies of a
    # collapsed repeat place near offset 0 and would swallow each other —
    # the very reads the multiplicity walk needs to traverse the repeat.
    contained: dict = {}  # read -> a read containing it
    dovetails = []
    for (a, b), (off, nv) in pair_off.items():
        La, Lb = lens[a], lens[b]
        # a[i] ~ b[i + off]
        olap = min(La, Lb - off) - max(0, -off)
        if olap < min_overlap:
            continue
        # slack tracks the voted offset's uncertainty (indel drift across
        # the overlap, ~a few percent), NOT the overlap size — too much
        # slack absorbs genuine short extensions into "containment"
        slack = max(20, olap // 25)
        if off >= -slack and off + La <= Lb + slack and not (
            mult[a] >= 2 and mult[b] >= 2
        ):
            inner = a if La <= Lb else b
            contained.setdefault(inner, b if inner == a else a)
        elif -off >= -slack and -off + Lb <= La + slack and not (
            mult[a] >= 2 and mult[b] >= 2
        ):
            inner = b if Lb <= La else a
            contained.setdefault(inner, a if inner == b else b)
        elif off > 0:
            # off = position of a's origin in b's frame, so b starts first
            dovetails.append((nv, b, a, off))  # b then a, a starts at off in b
        else:
            dovetails.append((nv, a, b, -off))  # a then b, b starts at -off in a

    dovetails = [d for d in dovetails
                 if d[1] not in contained and d[2] not in contained]
    alive = [i for i in range(len(ids)) if i not in contained]

    succ: dict = defaultdict(list)  # u -> [(votes, v, t)] with v starting t
    has_pred: set = set()
    for nv, u, v, t in dovetails:
        succ[u].append((nv, v, t))
        has_pred.add(v)
    for lst in succ.values():
        lst.sort(key=lambda e: -e[0])

    remaining = dict(mult)

    def _score(v):
        """Repeat-first traversal: prefer a successor that leads (back)
        into higher-multiplicity reads — a tandem repeat's re-entry
        junction outranks its exit, so the walk traverses the second copy
        while placements remain, then exits. Unique-region candidates all
        score 1 and fall back to vote order (the old greedy)."""
        s = mult.get(v, 1)
        for _nv, w, _t in succ.get(v, ()):
            if remaining.get(w, 0) > 0:
                s = max(s, mult.get(w, 1))
        return s

    containees: dict = defaultdict(list)
    for c, outer in contained.items():
        seen = {c}
        while outer in contained and outer not in seen:
            seen.add(outer)
            outer = contained[outer]
        containees[outer].append(c)

    # seeds: chain heads first (no incoming dovetail), longest first
    seed_order = sorted(
        alive, key=lambda i: (i in has_pred, -lens[i], i)
    )
    contigs = []
    for seed in seed_order:
        if remaining.get(seed, 0) <= 0:
            continue
        chain = [seed]
        offs = [0]
        remaining[seed] -= 1
        cur = seed
        while True:
            cands = [
                (nv, v, t)
                for nv, v, t in succ.get(cur, ())
                if remaining.get(v, 0) > 0 and t > 0
            ]
            if not cands:
                break
            nv, nxt, t = max(cands, key=lambda e: (_score(e[1]), e[0]))
            remaining[nxt] -= 1
            offs.append(offs[-1] + t)
            chain.append(nxt)
            cur = nxt
        draft_end = 0
        draft_parts = []
        for i, off in zip(chain, offs):
            s = oriented[ids[i]]
            if off + len(s) > draft_end:
                draft_parts.append(s[max(0, draft_end - off):])
                draft_end = off + len(s)
        draft = "".join(draft_parts)
        members = [ids[i] for i in chain]
        for i in chain:
            for c in containees.get(i, ()):
                members.append(ids[c])
        contigs.append((draft, members))

    # repeat resolution: extend each collapsed contig through copy
    # junctions, then join contigs whose extended ends meet
    extended = []
    for draft, members in contigs:
        draft, members = _extend_contig_through_repeats(
            draft, members, oriented, k=k, min_votes=min_votes,
        )
        extended.append((draft, members))
    merged = _merge_extended_contigs(
        extended, k=k, min_votes=min_votes, min_overlap=min_overlap
    )

    final = []
    for draft, members in merged:
        members = list(dict.fromkeys(members))
        pool = {r: reads[r] for r in members if r in reads}
        if len(pool) > 1:
            draft = polish(
                draft, pool,
                iterations=polish_iterations, band_width=band_width,
            )
        final.append((draft, members))
    final.sort(key=lambda c: -len(c[0]))
    return final


def assemble_path(fastq_path, out_dir, iterations=3, band_width=512):
    reads = parse_fastq(fastq_path)
    if not reads:
        return None
    contigs = assemble_reads(
        {r: v["sequence"] for r, v in reads.items()},
        polish_iterations=iterations, band_width=band_width,
    )
    if not contigs:
        return None
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "assembly.fasta")
    records = [
        f">contig_{n + 1} length={len(seq)} reads={len(members)}\n{seq}"
        for n, (seq, members) in enumerate(contigs)
    ]
    write_fasta(out_path, records)
    return out_path


def assemble_full_length_paths(output_dir, cores=1):
    """(result_utils.py:1267-1288)"""
    fastq_files = glob.glob(
        os.path.join(output_dir, "AMR_allele_fastqs", "path_reads", "*.fastq.gz")
    )
    assembly_dir = os.path.join(output_dir, "path_assemblies")
    os.makedirs(assembly_dir, exist_ok=True)
    for fastq_file in fastq_files:
        path_id = os.path.basename(fastq_file).replace(".fastq.gz", "")
        try:
            assemble_path(
                fastq_file, os.path.join(assembly_dir, f"path_{path_id}")
            )
        except Exception as e:  # match the reference's log-and-skip behavior
            sys.stderr.write(
                f"\namira-tpu: error assembling path {path_id}: {e}\n"
            )
            continue

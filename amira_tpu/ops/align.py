"""Banded two-piece-affine local alignment on device (minimap2 replacement).

The reference shells out to minimap2 (`-a --MD -x map-ont --eqx`,
result_utils.py:259-276) for read->allele and allele->allele alignment. Here
alignment is a batched JAX kernel: a scan over query rows carrying
M/I/D/I2/D2 band-vectors (two-piece affine gaps, minimap2's -O 4,24 -E 2,1),
with each horizontal (deletion) recurrence rewritten as a cumulative max so
every lane of the band updates in parallel. Traceback directions are packed
into one byte per cell and walked ON DEVICE by a fused scan
(_batched_sw_cigar) that emits 2-bit-packed =/X/I/D op sequences (minimap2
--eqx semantics), so the band matrix (W x Lq bytes per job) stays on the
device and only the packed ops (~Lq/4 bytes) are copied to the host.

Band placement is seed-chain-extend: shared-15-mer hits are clustered by
diagonal into chains, the top chains each get a banded extension, z-drop
(minimap2 -z) splits alignments across bad joins, and collinear chain pieces
are stitched back together with two-piece gap costs — so a read with a
structural gap wider than the band still maps as one alignment with a long
I/D run. Pairs with no seeds are reported unmapped.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from amira_tpu.sketch import encode_dna

NEG = -(2**28)

# ONT-style scoring (minimap2 map-ont: A=2, B=4, O=4,24, E=2,1, z=400)
MATCH = 2
MISMATCH = -4
GAP_OPEN = 6  # first gap base, short piece: O1 + E1
GAP_EXT = 2
GAP_OPEN2 = 25  # first gap base, long piece: O2 + E2
GAP_EXT2 = 1
ZDROP = 400


def gap_cost(g: int) -> int:
    """Two-piece affine cost of a gap of length g (minimap2 semantics)."""
    if g <= 0:
        return 0
    return min(GAP_OPEN + (g - 1) * GAP_EXT, GAP_OPEN2 + (g - 1) * GAP_EXT2)


@partial(jax.jit, static_argnames=("W",))
def _banded_sw_kernel(q, r_padded, q_len, dlo, W: int):
    """One banded local alignment with two-piece affine gaps.

    q:        (Lq,) uint8 query codes (0..3, 4=N/pad)
    r_padded: uint8 ref codes padded with 4s, real ref at offset W + Lq
    q_len:    scalar actual query length
    dlo:      scalar band lower diagonal (j - i >= dlo)
    Returns (tb, best, best_i, best_w, best_state):
      tb: (Lq, W) uint8 packed traceback
          bits 0-2: M predecessor (0 start, 1 M, 2 I, 3 D, 4 I2, 5 D2)
          bit 3: I extends (else opens from M)
          bit 4: D extends (else opens from M)
          bit 5: I2 extends (else opens from M)
          bit 6: D2 extends (else opens from M)
          bit 7: query char matches ref char (traceback emits = vs X from
                 this bit alone — no char gathers during the walk)
      best_state: 0=M, 1=I, 2=D, 3=I2, 4=D2 at the maximum cell
    """
    Lq = q.shape[0]
    neg = jnp.int32(NEG)
    w_idx = jnp.arange(W, dtype=jnp.int32)

    def row(carry, i):
        M_prev, I_prev, D_prev, I2_prev, D2_prev, best, bi, bw, bs = carry
        qc = q[i]
        # ref chars for this row's band: j = i + dlo + w (offset W+Lq pad)
        rwin = jax.lax.dynamic_slice_in_dim(r_padded, i + dlo + W + Lq, W)
        j = i + dlo + w_idx
        in_ref = (j >= 0) & (rwin != 4)
        eq = rwin == qc
        eq_bit = eq.astype(jnp.uint8) << 7
        s = jnp.where(eq, MATCH, MISMATCH)
        # diagonal move: (i-1, j-1) is the same w in band coordinates
        gap_best = jnp.maximum(
            jnp.maximum(I_prev, D_prev), jnp.maximum(I2_prev, D2_prev)
        )
        prev_best = jnp.maximum(M_prev, gap_best)
        m_pred = jnp.where(
            M_prev >= gap_best,
            1,
            jnp.where(
                I_prev >= jnp.maximum(D_prev, jnp.maximum(I2_prev, D2_prev)),
                2,
                jnp.where(
                    D_prev >= jnp.maximum(I2_prev, D2_prev),
                    3,
                    jnp.where(I2_prev >= D2_prev, 4, 5),
                ),
            ),
        ).astype(jnp.uint8)
        # a fresh local start treats any non-positive (or out-of-band)
        # predecessor as score 0
        M_diag = jnp.maximum(prev_best, 0) + s
        M_cur = jnp.maximum(0, M_diag)
        # a path only continues through a predecessor with positive score;
        # otherwise this cell is a fresh local start (SW semantics)
        m_bits = jnp.where((M_diag > 0) & (prev_best > 0), m_pred, 0).astype(
            jnp.uint8
        )
        M_cur = jnp.where(in_ref, M_cur, neg)
        # vertical moves (insertion in query): from (i-1, j) = band w+1
        M_up = jnp.concatenate([M_prev[1:], jnp.full((1,), neg, jnp.int32)])
        I_up = jnp.concatenate([I_prev[1:], jnp.full((1,), neg, jnp.int32)])
        I2_up = jnp.concatenate([I2_prev[1:], jnp.full((1,), neg, jnp.int32)])
        I_open = M_up - GAP_OPEN
        I_ext = I_up - GAP_EXT
        I_cur = jnp.maximum(I_open, I_ext)
        i_bits = (I_ext >= I_open).astype(jnp.uint8) << 3
        I_cur = jnp.where(in_ref, I_cur, neg)
        I2_open = M_up - GAP_OPEN2
        I2_ext = I2_up - GAP_EXT2
        I2_cur = jnp.maximum(I2_open, I2_ext)
        i2_bits = (I2_ext >= I2_open).astype(jnp.uint8) << 5
        I2_cur = jnp.where(in_ref, I2_cur, neg)
        # horizontal moves (deletion in ref): sequential in w, computed as a
        # cumulative max:  D[w] = max_{w0 < w} M[w0] - OPEN - (w-1-w0)*EXT
        A = M_cur + w_idx * GAP_EXT
        A_cum = jax.lax.cummax(A)
        A_shift = jnp.concatenate([jnp.full((1,), neg, jnp.int32), A_cum[:-1]])
        D_cur = A_shift - GAP_OPEN - (w_idx - 1) * GAP_EXT
        D_cur = jnp.maximum(D_cur, neg)
        # direction bit: did D extend from D[w-1] or open from M[w-1]?
        D_left = jnp.concatenate([jnp.full((1,), neg, jnp.int32), D_cur[:-1]])
        M_left = jnp.concatenate([jnp.full((1,), neg, jnp.int32), M_cur[:-1]])
        d_bits = ((D_left - GAP_EXT) >= (M_left - GAP_OPEN)).astype(jnp.uint8) << 4
        D_cur = jnp.where(in_ref, D_cur, neg)
        A2 = M_cur + w_idx * GAP_EXT2
        A2_cum = jax.lax.cummax(A2)
        A2_shift = jnp.concatenate(
            [jnp.full((1,), neg, jnp.int32), A2_cum[:-1]]
        )
        D2_cur = A2_shift - GAP_OPEN2 - (w_idx - 1) * GAP_EXT2
        D2_cur = jnp.maximum(D2_cur, neg)
        D2_left = jnp.concatenate(
            [jnp.full((1,), neg, jnp.int32), D2_cur[:-1]]
        )
        d2_bits = (
            (D2_left - GAP_EXT2) >= (M_left - GAP_OPEN2)
        ).astype(jnp.uint8) << 6
        D2_cur = jnp.where(in_ref, D2_cur, neg)

        live = i < q_len
        M_cur = jnp.where(live, M_cur, neg)
        I_cur = jnp.where(live, I_cur, neg)
        D_cur = jnp.where(live, D_cur, neg)
        I2_cur = jnp.where(live, I2_cur, neg)
        D2_cur = jnp.where(live, D2_cur, neg)
        tb_row = m_bits | i_bits | d_bits | i2_bits | d2_bits | eq_bit

        # track the global maximum cell and its state
        gap_cur = jnp.maximum(
            jnp.maximum(I_cur, D_cur), jnp.maximum(I2_cur, D2_cur)
        )
        row_best_state = jnp.where(
            M_cur >= gap_cur,
            0,
            jnp.where(
                I_cur >= jnp.maximum(D_cur, jnp.maximum(I2_cur, D2_cur)),
                1,
                jnp.where(
                    D_cur >= jnp.maximum(I2_cur, D2_cur),
                    2,
                    jnp.where(I2_cur >= D2_cur, 3, 4),
                ),
            ),
        )
        row_vals = jnp.maximum(M_cur, gap_cur)
        rw = jnp.argmax(row_vals)
        rv = row_vals[rw]
        upd = rv > best
        best = jnp.where(upd, rv, best)
        bi = jnp.where(upd, i, bi)
        bw = jnp.where(upd, rw.astype(jnp.int32), bw)
        bs = jnp.where(upd, row_best_state[rw], bs)
        return (
            M_cur, I_cur, D_cur, I2_cur, D2_cur, best, bi, bw, bs
        ), tb_row

    init = (
        # virtual row -1: H = 0 everywhere (fresh local starts), gaps closed
        jnp.zeros((W,), jnp.int32),
        jnp.full((W,), neg, jnp.int32),
        jnp.full((W,), neg, jnp.int32),
        jnp.full((W,), neg, jnp.int32),
        jnp.full((W,), neg, jnp.int32),
        jnp.int32(0),
        jnp.int32(-1),
        jnp.int32(-1),
        jnp.int32(0),
    )
    (M, I, D, I2, D2, best, bi, bw, bs), tb = jax.lax.scan(
        row, init, jnp.arange(Lq, dtype=jnp.int32)
    )
    return tb, best, bi, bw, bs


def _preshift_refs(rs_padded, dlos, Lq: int, W: int):
    """Gather each lane's band-relevant reference window ONCE so every DP row
    can slice it at a UNIFORM index: rsh[b, t] = rs_padded[b, t+dlo[b]+W+Lq]
    for t in [0, Lq + W). Row i's band chars are then rsh[:, i : i + W] — a
    batch-independent dynamic slice, which XLA lowers as a cheap strided load
    instead of a per-row per-lane gather."""
    t_idx = jnp.arange(Lq + W, dtype=jnp.int32)
    gidx = dlos[:, None].astype(jnp.int32) + t_idx[None, :] + W + Lq
    return jnp.take_along_axis(rs_padded, gidx, axis=1)


def _banded_sw_batch_core(qs, rsh, qlens, W: int):
    """Batch-major banded SW: carries are (B, W) matrices (band minor),
    bit-identical to vmapping `_banded_sw_kernel` over the batch (pinned by
    tests/test_device_traceback.py); the per-row reference window load is a
    uniform slice of the pre-shifted `rsh` (see _preshift_refs).

    Returns (tb, best, bi, bw, bs) with tb in scan-major (Lq, B, W) layout.
    """
    B, Lq = qs.shape
    neg = jnp.int32(NEG)
    w_idx = jnp.arange(W, dtype=jnp.int32)

    def _shift_up(x):
        return jnp.concatenate(
            [x[:, 1:], jnp.full((B, 1), neg, jnp.int32)], axis=1
        )

    def _shift_left(x):
        return jnp.concatenate(
            [jnp.full((B, 1), neg, jnp.int32), x[:, :-1]], axis=1
        )

    def row(carry, i):
        M_prev, I_prev, D_prev, I2_prev, D2_prev, best, bi, bw, bs = carry
        qc = jax.lax.dynamic_slice_in_dim(qs, i, 1, axis=1)
        rwin = jax.lax.dynamic_slice_in_dim(rsh, i, W, axis=1)
        # left pad of rs_padded is all 4s, so j < 0 lands on code 4 too:
        # one mask covers both out-of-ref conditions
        in_ref = rwin != 4
        eq = rwin == qc
        eq_bit = eq.astype(jnp.uint8) << 7
        s = jnp.where(eq, MATCH, MISMATCH)
        gap_best = jnp.maximum(
            jnp.maximum(I_prev, D_prev), jnp.maximum(I2_prev, D2_prev)
        )
        prev_best = jnp.maximum(M_prev, gap_best)
        m_pred = jnp.where(
            M_prev >= gap_best,
            1,
            jnp.where(
                I_prev >= jnp.maximum(D_prev, jnp.maximum(I2_prev, D2_prev)),
                2,
                jnp.where(
                    D_prev >= jnp.maximum(I2_prev, D2_prev),
                    3,
                    jnp.where(I2_prev >= D2_prev, 4, 5),
                ),
            ),
        ).astype(jnp.uint8)
        M_diag = jnp.maximum(prev_best, 0) + s
        M_cur = jnp.maximum(0, M_diag)
        m_bits = jnp.where((M_diag > 0) & (prev_best > 0), m_pred, 0).astype(
            jnp.uint8
        )
        M_cur = jnp.where(in_ref, M_cur, neg)
        M_up = _shift_up(M_prev)
        I_up = _shift_up(I_prev)
        I2_up = _shift_up(I2_prev)
        I_open = M_up - GAP_OPEN
        I_ext = I_up - GAP_EXT
        I_cur = jnp.maximum(I_open, I_ext)
        i_bits = (I_ext >= I_open).astype(jnp.uint8) << 3
        I_cur = jnp.where(in_ref, I_cur, neg)
        I2_open = M_up - GAP_OPEN2
        I2_ext = I2_up - GAP_EXT2
        I2_cur = jnp.maximum(I2_open, I2_ext)
        i2_bits = (I2_ext >= I2_open).astype(jnp.uint8) << 5
        I2_cur = jnp.where(in_ref, I2_cur, neg)
        A = M_cur + w_idx[None, :] * GAP_EXT
        A_shift = _shift_left(jax.lax.cummax(A, axis=1))
        D_cur = jnp.maximum(
            A_shift - GAP_OPEN - (w_idx[None, :] - 1) * GAP_EXT, neg
        )
        D_left = _shift_left(D_cur)
        M_left = _shift_left(M_cur)
        d_bits = (
            (D_left - GAP_EXT) >= (M_left - GAP_OPEN)
        ).astype(jnp.uint8) << 4
        D_cur = jnp.where(in_ref, D_cur, neg)
        A2 = M_cur + w_idx[None, :] * GAP_EXT2
        A2_shift = _shift_left(jax.lax.cummax(A2, axis=1))
        D2_cur = jnp.maximum(
            A2_shift - GAP_OPEN2 - (w_idx[None, :] - 1) * GAP_EXT2, neg
        )
        D2_left = _shift_left(D2_cur)
        d2_bits = (
            (D2_left - GAP_EXT2) >= (M_left - GAP_OPEN2)
        ).astype(jnp.uint8) << 6
        D2_cur = jnp.where(in_ref, D2_cur, neg)
        live = i < qlens[:, None]
        M_cur = jnp.where(live, M_cur, neg)
        I_cur = jnp.where(live, I_cur, neg)
        D_cur = jnp.where(live, D_cur, neg)
        I2_cur = jnp.where(live, I2_cur, neg)
        D2_cur = jnp.where(live, D2_cur, neg)
        tb_row = m_bits | i_bits | d_bits | i2_bits | d2_bits | eq_bit
        gap_cur = jnp.maximum(
            jnp.maximum(I_cur, D_cur), jnp.maximum(I2_cur, D2_cur)
        )
        row_best_state = jnp.where(
            M_cur >= gap_cur,
            0,
            jnp.where(
                I_cur >= jnp.maximum(D_cur, jnp.maximum(I2_cur, D2_cur)),
                1,
                jnp.where(
                    D_cur >= jnp.maximum(I2_cur, D2_cur),
                    2,
                    jnp.where(I2_cur >= D2_cur, 3, 4),
                ),
            ),
        )
        row_vals = jnp.maximum(M_cur, gap_cur)
        rw = jnp.argmax(row_vals, axis=1)
        rv = jnp.take_along_axis(row_vals, rw[:, None], axis=1)[:, 0]
        upd = rv > best
        best = jnp.where(upd, rv, best)
        bi = jnp.where(upd, i, bi)
        bw = jnp.where(upd, rw.astype(jnp.int32), bw)
        bs = jnp.where(
            upd,
            jnp.take_along_axis(row_best_state, rw[:, None], axis=1)[:, 0],
            bs,
        )
        return (
            M_cur, I_cur, D_cur, I2_cur, D2_cur, best, bi, bw, bs
        ), tb_row

    init = (
        jnp.zeros((B, W), jnp.int32),
        jnp.full((B, W), neg, jnp.int32),
        jnp.full((B, W), neg, jnp.int32),
        jnp.full((B, W), neg, jnp.int32),
        jnp.full((B, W), neg, jnp.int32),
        jnp.zeros((B,), jnp.int32),
        jnp.full((B,), -1, jnp.int32),
        jnp.full((B,), -1, jnp.int32),
        jnp.zeros((B,), jnp.int32),
    )
    (_M, _I, _D, _I2, _D2, best, bi, bw, bs), tb = jax.lax.scan(
        row, init, jnp.arange(Lq, dtype=jnp.int32)
    )
    return tb, best, bi, bw, bs


@partial(jax.jit, static_argnames=("W",))
def _batched_sw(qs, rs_padded, qlens, dlos, W: int):
    """Batched DP returning tb in the (B, Lq, W) layout the host
    traceback walks."""
    rsh = _preshift_refs(rs_padded, dlos, qs.shape[1], W)
    tb, best, bi, bw, bs = _banded_sw_batch_core(qs, rsh, qlens, W)
    return tb.transpose(1, 0, 2), best, bi, bw, bs


# Device traceback: op codes (2 bits each, packed 4-per-byte for transfer)
_OP_EQ, _OP_X, _OP_I, _OP_D = 0, 1, 2, 3
_OPS_STR = "=XID"


def _tb_steps(Lq: int, W: int) -> int:
    """Worst-case traceback path length: every query row consumed (M/I) plus
    every band lane crossed by deletions (initial w + one per insertion),
    rounded up to a multiple of 4 for 2-bit packing."""
    s = 2 * Lq + W + 2
    return (s + 3) & ~3


def _traceback_batch(tb, B: int, Lq: int, best, bi, bw, bs, W: int):
    """Batch-major traceback over the scan-major (Lq, B, W) band matrix —
    per step ONE flat B-point gather (=/X comes from the tb byte's match
    bit, so the walk touches no query/reference characters at all).
    Bit-identical op sequences to the host `_traceback` walk for every lane
    with a positive best score (garbage lanes may read different padding)."""
    S = _tb_steps(Lq, W)
    pred_state = jnp.array([0, 0, 1, 2, 3, 4, 0, 0], dtype=jnp.int32)
    lane = jnp.arange(B, dtype=jnp.int32)
    tb_flat = tb.reshape(-1)

    def step(carry, _):
        i, w, state, done, n = carry
        live = jnp.logical_and(jnp.logical_not(done), i >= 0)
        ic = jnp.clip(i, 0, Lq - 1)
        wc = jnp.clip(w, 0, W - 1)
        byte = jnp.take(tb_flat, (ic * B + lane) * W + wc).astype(jnp.int32)
        m_op = jnp.where((byte >> 7) & 1, _OP_EQ, _OP_X).astype(jnp.int32)
        pred = byte & 7
        is_m = state == 0
        is_i = state == 1
        is_d = state == 2
        is_i2 = state == 3
        op = jnp.where(
            is_m, m_op, jnp.where(jnp.logical_or(is_i, is_i2), _OP_I, _OP_D)
        )
        ext = jnp.where(
            is_i,
            (byte >> 3) & 1,
            jnp.where(
                is_d,
                (byte >> 4) & 1,
                jnp.where(is_i2, (byte >> 5) & 1, (byte >> 6) & 1),
            ),
        )
        gap_state = jnp.where(ext == 1, state, 0)
        nstate = jnp.where(is_m, pred_state[pred], gap_state)
        di = jnp.where(
            jnp.logical_or(is_m, jnp.logical_or(is_i, is_i2)), 1, 0
        )
        dw = jnp.where(
            jnp.logical_or(is_i, is_i2),
            1,
            jnp.where(jnp.logical_or(is_d, state == 4), -1, 0),
        )
        ndone = jnp.logical_or(done, jnp.logical_and(is_m, pred == 0))
        i = jnp.where(live, i - di, i)
        w = jnp.where(live, w + dw, w)
        state = jnp.where(live, nstate, state)
        done = jnp.where(live, ndone, done)
        n = n + jnp.where(live, 1, 0).astype(jnp.int32)
        op_out = jnp.where(live, op, 0).astype(jnp.uint8)
        return (i, w, state, done, n), op_out

    init = (
        bi.astype(jnp.int32),
        bw.astype(jnp.int32),
        bs.astype(jnp.int32),
        jnp.logical_or(bi < 0, best <= 0),
        jnp.zeros((B,), jnp.int32),
    )
    # chunked early-exit walk: typical paths finish in ~Lq steps but the
    # provable bound is 2Lq + W; a while_loop over 256-step chunks stops as
    # soon as every lane is done (2-4x fewer steps on real batches). Dead
    # lanes emit op 0, so unvisited chunks equal the zeros they hold.
    CH = 256
    Sr = (S + CH - 1) // CH * CH
    ops_buf = jnp.zeros((Sr, B), jnp.uint8)

    def chunk_cond(state):
        c, carry, _ops = state
        return jnp.logical_and(c < Sr // CH, jnp.logical_not(jnp.all(carry[3])))

    def chunk_body(state):
        c, carry, ops_buf = state
        carry, ops_chunk = jax.lax.scan(step, carry, None, length=CH)
        ops_buf = jax.lax.dynamic_update_slice_in_dim(
            ops_buf, ops_chunk, c * CH, axis=0
        )
        return c + 1, carry, ops_buf

    _c, (fi, fw, _fs, _fd, n_steps), ops = jax.lax.while_loop(
        chunk_cond, chunk_body, (jnp.int32(0), init, ops_buf)
    )
    q_start = fi + 1
    shifts = jnp.arange(0, 8, 2, dtype=jnp.int32)
    packed = jnp.sum(
        ops.transpose(1, 0).reshape(B, Sr // 4, 4).astype(jnp.int32)
        << shifts[None, None, :],
        axis=2,
    ).astype(jnp.uint8)
    return packed, n_steps, q_start, fw


@partial(jax.jit, static_argnames=("W",))
def _batched_sw_cigar(qs, rs, qlens, dlos, W: int):
    """Fused DP + traceback: the band matrix never leaves the device; only
    2-bit-packed op sequences (plus endpoints) transfer to host."""
    B, Lq = qs.shape
    rsh = _preshift_refs(rs, dlos, Lq, W)
    tb, best, bi, bw, bs = _banded_sw_batch_core(qs, rsh, qlens, W)
    packed, n_steps, q0, fw = _traceback_batch(
        tb, B, Lq, best, bi, bw, bs, W
    )
    r0 = q0 + dlos.astype(jnp.int32) + fw
    return packed, n_steps, q0, r0, best, bi, bw


_DEVICE_TB: bool | None = None


def _use_device_traceback() -> bool:
    """Walk the traceback on the device on an accelerator backend (only the
    ~Lq/4 packed op bytes per job are copied back instead of the W x Lq band
    matrix); on the CPU backend the band matrix is already in host memory
    and the sequential traceback scan is slower than walking it in Python.
    Both give identical alignments (tests/test_device_traceback.py).
    Override with AMIRA_TPU_DEVICE_TRACEBACK=0/1."""
    global _DEVICE_TB
    import os

    env = os.environ.get("AMIRA_TPU_DEVICE_TRACEBACK")
    if env is not None:
        return env not in ("0", "false", "")
    if _DEVICE_TB is None:
        _DEVICE_TB = jax.devices()[0].platform != "cpu"
    return _DEVICE_TB


def _unpack_cigar(packed_row: np.ndarray, n: int):
    """Host: 2-bit unpack + run-length encode one job's op sequence into
    [(op, len), ...] cigar tuples (ops arrive back-to-front)."""
    if n <= 0:
        return []
    nbytes = (n + 3) // 4
    b = packed_row[:nbytes].astype(np.uint8)
    ops = np.empty(nbytes * 4, dtype=np.uint8)
    ops[0::4] = b & 3
    ops[1::4] = (b >> 2) & 3
    ops[2::4] = (b >> 4) & 3
    ops[3::4] = (b >> 6) & 3
    ops = ops[:n][::-1]
    change = np.flatnonzero(ops[1:] != ops[:-1])
    starts = np.concatenate([[0], change + 1])
    ends = np.concatenate([change + 1, [n]])
    return [
        (_OPS_STR[ops[s]], int(e - s)) for s, e in zip(starts, ends)
    ]


@dataclass
class Alignment:
    """A local alignment of query against ref (one SAM record equivalent)."""

    q_start: int
    q_end: int  # exclusive
    r_start: int
    r_end: int  # exclusive
    score: int
    cigar: list  # [(op, length)] with ops in "=XID"
    q_len: int
    r_len: int

    @property
    def matching_bases(self) -> int:
        return sum(n for op, n in self.cigar if op == "=")

    @property
    def aligned_ref_positions(self):
        return (self.r_start, self.r_end)

    def cigar_string(self, with_clips=True) -> str:
        parts = []
        if with_clips and self.q_start > 0:
            parts.append(f"{self.q_start}S")
        parts.extend(f"{n}{op}" for op, n in self.cigar)
        if with_clips and self.q_len - self.q_end > 0:
            parts.append(f"{self.q_len - self.q_end}S")
        return "".join(parts)

    def cigar_tuples(self, with_clips=True):
        """pysam-style (op_code, length) tuples: = ->7, X->8, I->1, D->2, S->4."""
        code = {"=": 7, "X": 8, "I": 1, "D": 2}
        out = []
        if with_clips and self.q_start > 0:
            out.append((4, self.q_start))
        out.extend((code[op], n) for op, n in self.cigar)
        if with_clips and self.q_len - self.q_end > 0:
            out.append((4, self.q_len - self.q_end))
        return out

    def identity(self) -> float:
        """matching / (aligned cols excluding clips), minimap2 --eqx style."""
        total = sum(n for _, n in self.cigar)
        return self.matching_bases / total if total else 0.0


_COMP = str.maketrans("ACGTacgt", "TGCAtgca")


def reverse_complement(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


_KMER_SENTINEL = np.uint64(1) << np.uint64(62)


def _seed_chains(
    qcodes, ref_index, k=15, band_width=256, max_occ=8, max_chains=4,
    qkmers=None,
):
    """Cluster shared-k-mer diagonals into chains (minimap2's chaining stage).

    All ref occurrences of each query k-mer (capped at max_occ to skip
    repeats) contribute a (diagonal = ref_pos - q_pos) hit; hits are grouped
    into chains wherever consecutive sorted diagonals jump by more than half
    the band width. Returns up to max_chains (median_diag, n_seeds) tuples
    sorted by seed count descending — each gets its own banded extension, so
    a structural gap wider than the band shows up as two chains that the
    stitcher rejoins. `qkmers` lets callers that probe MANY references with
    one query pass the query's (kmers, positions) once instead of
    re-extracting per reference."""
    if qkmers is None:
        qkmers = query_seed_kmers(qcodes, k)
    qk, qpos = qkmers
    if len(qk) == 0:
        return []
    rk_codes, rk_pos = ref_index
    if len(rk_codes) == 0:
        return []
    lo = np.searchsorted(rk_codes, qk, side="left")
    hi = np.searchsorted(rk_codes, qk, side="right")
    counts = hi - lo
    keep = (counts > 0) & (counts <= max_occ)
    if not keep.any():
        return []
    reps = counts[keep]
    total = int(reps.sum())
    # expand [lo, hi) ranges without a Python loop
    starts = np.repeat(lo[keep], reps)
    offsets = np.concatenate([[0], np.cumsum(reps)[:-1]])
    within = np.arange(total, dtype=np.int64) - np.repeat(offsets, reps)
    diags = rk_pos[starts + within] - np.repeat(qpos[keep], reps)
    order = np.argsort(diags, kind="stable")
    d_sorted = diags[order]
    breaks = np.nonzero(np.diff(d_sorted) > band_width // 2)[0] + 1
    bounds = np.concatenate([[0], breaks, [total]])
    chains = []
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        seg = d_sorted[b0:b1]
        chains.append((int(np.median(seg)), int(b1 - b0)))
    chains.sort(key=lambda c: -c[1])
    return chains[:max_chains]


def query_seed_kmers(qcodes: np.ndarray, k: int = 15):
    """One query's valid forward k-mers + their positions (the per-query
    half of seed chaining, extracted once per strand)."""
    qk = _forward_kmers(qcodes, k)
    qpos = np.nonzero(qk != _KMER_SENTINEL)[0]
    return qk[qpos], qpos


def _forward_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """Forward-strand packed k-mers (invalid windows -> sentinel removed)."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)
    acc = np.zeros(n, dtype=np.uint64)
    valid = np.ones(n, dtype=bool)
    for j in range(k):
        b = codes[j : j + n]
        valid &= b != 255
        acc = (acc << np.uint64(2)) | (b.astype(np.uint64) & np.uint64(3))
    return np.where(valid, acc, np.uint64(1) << np.uint64(62))


def build_ref_seed_index(rcodes: np.ndarray, k: int = 15):
    """Sorted (kmer, position) arrays for seed lookup."""
    rk = _forward_kmers(rcodes, k)
    pos = np.nonzero(rk != _KMER_SENTINEL)[0].astype(np.int64)
    rk = rk[pos]
    order = np.argsort(rk, kind="stable")
    return rk[order], pos[order]


_FINE_BUCKETS = None


def _use_fine_buckets() -> bool:
    """Quarter-pow2 length buckets on the CPU backend: the DP cost there is
    compute-bound, so padding a 1.1 kb read to 2048 wastes ~45% of the
    band rows. On an accelerator the pow2 ladder stays, which keeps the
    number of compiled shapes (and so compile time) low. Override with
    AMIRA_TPU_FINE_BUCKETS=0/1."""
    global _FINE_BUCKETS
    if _FINE_BUCKETS is None:
        import os

        env = os.environ.get("AMIRA_TPU_FINE_BUCKETS")
        if env is not None:
            _FINE_BUCKETS = env not in ("0", "false", "")
        else:
            _FINE_BUCKETS = jax.devices()[0].platform == "cpu"
    return _FINE_BUCKETS


def _bucket(n: int, minimum: int = 64) -> int:
    b = minimum
    while b < n:
        b *= 2
    if b > minimum and _use_fine_buckets():
        step = b // 4
        return ((n + step - 1) // step) * step
    return b


def _traceback(tb, q, r, bi, bw, bstate, dlo):
    """Host traceback from the max cell to the local start; returns
    (cigar, q_start, r_start, q_end, r_end)."""
    ops = []
    i, w, state = int(bi), int(bw), int(bstate)
    q_end = i + 1
    r_end = i + dlo + w + 1
    while i >= 0:
        byte = int(tb[i, w])
        if state == 0:  # M
            j = i + dlo + w
            ops.append("=" if q[i] == r[j] else "X")
            pred = byte & 7
            i -= 1
            if pred == 0:
                break
            # pred: 1 -> M, 2 -> I, 3 -> D, 4 -> I2, 5 -> D2
            state = {1: 0, 2: 1, 3: 2, 4: 3, 5: 4}[pred]
        elif state == 1:  # I: consumes query, band w+1 in previous row
            ops.append("I")
            ext = (byte >> 3) & 1
            i -= 1
            w += 1
            state = 1 if ext else 0
        elif state == 3:  # I2: long-piece insertion, same geometry as I
            ops.append("I")
            ext = (byte >> 5) & 1
            i -= 1
            w += 1
            state = 3 if ext else 0
        elif state == 4:  # D2: long-piece deletion, same geometry as D
            ops.append("D")
            ext = (byte >> 6) & 1
            w -= 1
            state = 4 if ext else 0
        else:  # D: consumes ref, band w-1 same row
            ops.append("D")
            ext = (byte >> 4) & 1
            w -= 1
            state = 2 if ext else 0
    q_start = i + 1
    r_start = q_start + dlo + w
    ops.reverse()
    # run-length encode
    cigar = []
    for op in ops:
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += 1
        else:
            cigar.append([op, 1])
    return [tuple(c) for c in cigar], q_start, r_start, q_end, r_end


def _cigar_score(cigar) -> int:
    """Exact two-piece-affine score of a cigar. Maximal I/D runs in a
    traceback always live in one gap piece (I and D runs are separated by at
    least one M op), so per-run gap_cost reproduces the DP's score."""
    score = 0
    for op, n in cigar:
        if op == "=":
            score += MATCH * n
        elif op == "X":
            score += MISMATCH * n
        else:
            score -= gap_cost(n)
    return score


def _push_op(cigar, op, n):
    if n <= 0:
        return
    if cigar and cigar[-1][0] == op:
        cigar[-1] = (op, cigar[-1][1] + n)
    else:
        cigar.append((op, n))


def _piece_from_ops(aln, cum, s, e):
    """Sub-alignment of aln covering op-boundary range [s, e), with leading/
    trailing gap ops stripped so pieces start and end on aligned columns."""
    cigar = list(aln.cigar[s:e])
    q0 = aln.q_start + cum[s][0]
    r0 = aln.r_start + cum[s][1]
    q1 = aln.q_start + cum[e][0]
    r1 = aln.r_start + cum[e][1]
    while cigar and cigar[0][0] in "ID":
        op, n = cigar.pop(0)
        if op == "I":
            q0 += n
        else:
            r0 += n
    while cigar and cigar[-1][0] in "ID":
        op, n = cigar.pop()
        if op == "I":
            q1 -= n
        else:
            r1 -= n
    if not cigar:
        return None
    score = _cigar_score(cigar)
    if score <= 0:
        return None
    return Alignment(
        q_start=q0, q_end=q1, r_start=r0, r_end=r1,
        score=score, cigar=cigar, q_len=aln.q_len, r_len=aln.r_len,
    )


def _zdrop_split(aln, z=ZDROP):
    """Split an alignment wherever the running score falls more than z below
    its running maximum (minimap2 -z): each kept piece ends at a running-max
    boundary and the next piece restarts at the following score minimum, so
    a bad join between two good blocks becomes two clean pieces (which the
    stitcher may rejoin with an explicit long gap instead)."""
    n_ops = len(aln.cigar)
    if n_ops <= 1:
        return [aln]
    cum = [(0, 0, 0)]
    q = r = sc = 0
    for op, n in aln.cigar:
        if op == "=":
            sc += MATCH * n
            q += n
            r += n
        elif op == "X":
            sc += MISMATCH * n
            q += n
            r += n
        elif op == "I":
            sc -= gap_cost(n)
            q += n
        else:
            sc -= gap_cost(n)
            r += n
        cum.append((q, r, sc))
    pieces = []
    s = 0
    split_any = False
    while s < n_ops:
        max_b, max_rel = s, 0
        cut = False
        b = s
        for b in range(s + 1, n_ops + 1):
            rel = cum[b][2] - cum[s][2]
            if rel > max_rel:
                max_rel, max_b = rel, b
            elif max_rel - rel > z:
                cut = True
                break
        end = max_b if max_rel > 0 else s
        if end > s:
            piece = _piece_from_ops(aln, cum, s, end)
            if piece is not None:
                pieces.append(piece)
        if not cut:
            break
        split_any = True
        # restart at the score minimum after the kept piece
        min_b, min_sc = end, cum[end][2]
        for b2 in range(end + 1, n_ops + 1):
            if cum[b2][2] < min_sc:
                min_sc, min_b = cum[b2][2], b2
        if min_b >= n_ops:
            break
        s = min_b
    if not split_any:
        return [aln]
    return pieces


def _trim_head(aln, q_min, r_min):
    """Trim leading cigar ops until the alignment starts at or after
    (q_min, r_min) in both coordinates; None if nothing usable remains."""
    q, r = aln.q_start, aln.r_start
    if q >= q_min and r >= r_min:
        return aln
    cigar = [list(c) for c in aln.cigar]
    idx = 0
    while idx < len(cigar) and (q < q_min or r < r_min):
        op, n = cigar[idx]
        if op in "=X":
            need = max(q_min - q, r_min - r)
            take = min(n, need)
            q += take
            r += take
            if take == n:
                idx += 1
            else:
                cigar[idx][1] = n - take
                break
        else:
            if op == "I":
                q += n
            else:
                r += n
            idx += 1
    rest = cigar[idx:]
    while rest and rest[0][0] in "ID":
        op, n = rest.pop(0)
        if op == "I":
            q += n
        else:
            r += n
    if not rest or q >= aln.q_end or r >= aln.r_end:
        return None
    rest = [tuple(c) for c in rest]
    score = _cigar_score(rest)
    if score <= 0:
        return None
    return Alignment(
        q_start=q, q_end=aln.q_end, r_start=r, r_end=aln.r_end,
        score=score, cigar=rest, q_len=aln.q_len, r_len=aln.r_len,
    )


def _try_merge(a, b):
    """Join two collinear pieces of the same (query, ref, strand) with
    explicit two-piece gap costs; None unless the join beats both parts
    (minimap2's long-gap patching between adjacent chains)."""
    if (b.q_start, b.r_start) < (a.q_start, a.r_start):
        a, b = b, a
    b2 = _trim_head(b, a.q_end, a.r_end)
    if b2 is None:
        return None
    q_gap = b2.q_start - a.q_end
    r_gap = b2.r_start - a.r_end
    sa = _cigar_score(a.cigar)
    joined = sa + b2.score - gap_cost(q_gap) - gap_cost(r_gap)
    if joined <= max(sa, _cigar_score(b.cigar)):
        return None
    cigar = list(a.cigar)
    _push_op(cigar, "I", q_gap)
    _push_op(cigar, "D", r_gap)
    for op, n in b2.cigar:
        _push_op(cigar, op, n)
    return Alignment(
        q_start=a.q_start, q_end=b2.q_end,
        r_start=a.r_start, r_end=b2.r_end,
        score=joined, cigar=cigar, q_len=a.q_len, r_len=a.r_len,
    )


def _stitch_pieces(pieces):
    """Greedily merge collinear alignment pieces (from separate chain bands
    or z-drop splits) until no join improves the score; returns the single
    best resulting alignment."""
    uniq = {}
    for p in pieces:
        uniq[(p.q_start, p.q_end, p.r_start, p.r_end, tuple(p.cigar))] = p
    parts = sorted(uniq.values(), key=lambda x: (x.q_start, x.r_start))
    while len(parts) > 1:
        best = None
        for x in range(len(parts)):
            for y in range(x + 1, len(parts)):
                m = _try_merge(parts[x], parts[y])
                if m is not None and (best is None or m.score > best[0].score):
                    best = (m, x, y)
        if best is None:
            break
        m, x, y = best
        parts = [p for i, p in enumerate(parts) if i not in (x, y)]
        parts.append(m)
        parts.sort(key=lambda a: (a.q_start, a.r_start))
    return max(parts, key=lambda a: a.score)


class _LazySeedIndex:
    """Per-reference seed index built on first access."""

    __slots__ = ("_aligner",)

    def __init__(self, aligner):
        self._aligner = aligner

    def __getitem__(self, name):
        a = self._aligner
        idx = a._seed_cache.get(name)
        if idx is None:
            idx = build_ref_seed_index(a.ref_codes[name], a.seed_k)
            a._seed_cache[name] = idx
        return idx


class Aligner:
    """Batched seed-chain-extend aligner against a fixed reference set."""

    def __init__(self, references: dict[str, str], band_width: int = 256, seed_k: int = 15):
        self.band_width = band_width
        self.seed_k = seed_k
        self.ref_names = list(references.keys())
        self.ref_seqs = {n: references[n] for n in self.ref_names}
        self.ref_codes = {n: encode_dna(references[n]) for n in self.ref_names}
        # seed indexes build on first use: diagonal-reuse callers
        # (map_with_diagonals) never pay for them
        self._seed_cache: dict = {}
        self.ref_seed_index = _LazySeedIndex(self)

    def map_with_diagonals(self, reads: dict[str, str], targets: dict):
        """Map each read against ONE reference on a known band placement —
        no seeding. `targets` = {read_id: (ref_name, strand, diag)} with
        diag = r_start - q_start of the expected alignment; the band is
        centered there (the polish loop reuses the previous iteration's
        alignment, which drifts far less than the band half-width).
        Returns {read_id: {ref: (strand, Alignment)}} like map_reads."""
        jobs = []
        for rid, seq in reads.items():
            tgt = targets.get(rid)
            if tgt is None:
                continue
            name, strand, diag = tgt
            qseq = seq if strand == "+" else reverse_complement(seq)
            jobs.append(((rid, name), strand, qseq, int(diag)))
        raw: dict = {}
        for (rid, name), strand, _qseq, aln in self._run_jobs(jobs):
            raw.setdefault((rid, name, strand), []).append(aln)
        results: dict = {}
        for (rid, name, strand), alns in raw.items():
            pieces = []
            for a in alns:
                pieces.extend(_zdrop_split(a))
            if not pieces:
                continue
            best = _stitch_pieces(pieces) if len(pieces) > 1 else pieces[0]
            per_read = results.setdefault(rid, {})
            prev = per_read.get(name)
            if prev is None or best.score > prev[1].score:
                per_read[name] = (strand, best)
        return results

    def map_sequence(self, seq: str, min_seeds: int = 2):
        """Map one query (both strands) against every reference; returns
        {ref_name: (strand, Alignment)} keeping the best-scoring strand."""
        return self.map_reads({"q": seq}, min_seeds).get("q", {})

    def _jobs_for(self, rid, seq, min_seeds, allowed=None):
        jobs = []  # (job_tag, strand, qseq, dlo) with job_tag = (rid, ref)
        names = self.ref_names if allowed is None else allowed
        for strand, qseq in (("+", seq), ("-", reverse_complement(seq))):
            qcodes = encode_dna(qseq)
            qkmers = query_seed_kmers(qcodes, self.seed_k)
            for name in names:
                chains = _seed_chains(
                    qcodes, self.ref_seed_index[name],
                    self.seed_k, self.band_width, qkmers=qkmers,
                )
                if not chains:
                    continue
                top = chains[0][1]
                for diag, cnt in chains:
                    # secondary chains need real support relative to the
                    # primary, or noise spawns spurious extension jobs
                    if cnt < min_seeds or cnt * 20 < top:
                        continue
                    jobs.append(((rid, name), strand, qseq, diag))
        return jobs

    def _run_jobs(self, jobs):
        """Execute alignment jobs grouped by query-length bucket."""
        W = self.band_width
        out = []
        by_bucket: dict = {}
        for job in jobs:
            lq = _bucket(len(job[2]))
            by_bucket.setdefault(lq, []).append(job)
        # cap traceback memory: with device traceback the band matrix stays
        # in device memory (~1 GB per launch); the host-traceback path
        # materializes it host-side, so keep those chunks smaller
        budget = (1 << 30) if _use_device_traceback() else (256 << 20)
        for lq, bucket_jobs in by_bucket.items():
            chunk = max(1, budget // (lq * W))
            for c0 in range(0, len(bucket_jobs), chunk):
                self._run_batch(bucket_jobs[c0 : c0 + chunk], lq, W, out)
        return out

    def _run_batch(self, batch, lq, W, out):
        # pad refs to a bucketed common length so compiles are reused
        lr_max = max(len(self.ref_codes[j[0][1]]) for j in batch)
        P = W + lq  # real-ref offset inside the padded buffer
        rlen = _bucket(lr_max + 2 * W + 2 * lq)
        qs, rs, qlens, dlos = [], [], [], []
        for tag, strand, qseq, diag in batch:
            qc = encode_dna(qseq)
            qpad = np.full(lq, 4, dtype=np.uint8)
            qpad[: len(qc)] = qc
            rc = self.ref_codes[tag[1]]
            rpad = np.full(rlen, 4, dtype=np.uint8)
            rpad[P : P + len(rc)] = rc
            # clamp band start: diagonals from "whole query before ref" to
            # "band starts at the last ref base"
            dlo = int(np.clip(diag - W // 2, -(lq - 1), max(len(rc) - 1, 0)))
            qs.append(qpad)
            rs.append(rpad)
            qlens.append(len(qc))
            dlos.append(dlo)
        # pad the batch dimension to a bucket so vmapped jits are reused
        n_pad = _bucket(len(batch), 8) - len(batch)
        for _ in range(n_pad):
            qs.append(np.full(lq, 4, dtype=np.uint8))
            rs.append(np.full(rlen, 4, dtype=np.uint8))
            qlens.append(0)
            dlos.append(0)
        qs_a = np.stack(qs)
        rs_a = np.stack(rs)
        qlens_a = np.asarray(qlens, np.int32)
        dlos_a = np.asarray(dlos, np.int32)
        if _use_device_traceback():
            packed, n_steps, q0s, r0s, best, bi, bw = _batched_sw_cigar(
                qs_a, rs_a, qlens_a, dlos_a, W
            )
            packed = np.asarray(packed)
            n_steps = np.asarray(n_steps)
            q0s = np.asarray(q0s)
            r0s = np.asarray(r0s)
            best = np.asarray(best)
            bi = np.asarray(bi)
            bw = np.asarray(bw)
            for bidx, (tag, strand, qseq, _diag) in enumerate(batch):
                if bi[bidx] < 0 or best[bidx] <= 0:
                    continue
                cigar = _unpack_cigar(packed[bidx], int(n_steps[bidx]))
                if not cigar:
                    continue
                aln = Alignment(
                    q_start=int(q0s[bidx]),
                    q_end=int(bi[bidx]) + 1,
                    r_start=int(r0s[bidx]),
                    r_end=int(bi[bidx]) + int(dlos[bidx]) + int(bw[bidx]) + 1,
                    score=int(best[bidx]),
                    cigar=cigar,
                    q_len=len(qseq),
                    r_len=len(self.ref_codes[tag[1]]),
                )
                out.append((tag, strand, qseq, aln))
            return
        tb, best, bi, bw, bs = _batched_sw(qs_a, rs_a, qlens_a, dlos_a, W)
        tb = np.asarray(tb)
        best = np.asarray(best)
        bi = np.asarray(bi)
        bw = np.asarray(bw)
        bs = np.asarray(bs)
        for bidx, (tag, strand, qseq, _diag) in enumerate(batch):
            if bi[bidx] < 0 or best[bidx] <= 0:
                continue
            qc = encode_dna(qseq)
            rc = self.ref_codes[tag[1]]
            cigar, q0, r0, q1, r1 = _traceback(
                tb[bidx], qc,
                np.concatenate([rc, np.full(W + lq, 4, np.uint8)]),
                bi[bidx], bw[bidx], bs[bidx], dlos[bidx],
            )
            aln = Alignment(
                q_start=q0, q_end=q1, r_start=r0, r_end=r1,
                score=int(best[bidx]), cigar=cigar,
                q_len=len(qseq), r_len=len(rc),
            )
            out.append((tag, strand, qseq, aln))

    def map_reads(self, reads: dict[str, str], min_seeds: int = 2, ref_subsets=None):
        """Map many reads in shared batched kernel launches; returns
        {read_id: {ref: (strand, Alignment)}}. `ref_subsets` optionally
        restricts each read to {read_id: [ref names]} (used to batch many
        independent per-cluster mapping problems into one launch set)."""
        jobs = []
        for rid, seq in reads.items():
            allowed = None if ref_subsets is None else ref_subsets.get(rid)
            jobs.extend(self._jobs_for(rid, seq, min_seeds, allowed))
        raw: dict = {}
        for (rid, name), strand, _qseq, aln in self._run_jobs(jobs):
            raw.setdefault((rid, name, strand), []).append(aln)
        results: dict = {}
        for (rid, name, strand), alns in raw.items():
            pieces = []
            for a in alns:
                pieces.extend(_zdrop_split(a))
            if not pieces:
                continue
            best = _stitch_pieces(pieces) if len(pieces) > 1 else pieces[0]
            per_read = results.setdefault(rid, {})
            prev = per_read.get(name)
            if prev is None or best.score > prev[1].score:
                per_read[name] = (strand, best)
        return results

"""Multi-scalar multiplication (Pippenger) in plain JAX.

Replaces the reference's TBB bucket MSM (rust-rapidsnark/rapidsnark/src/
multiexp.cpp:182-245: per-thread bucket privatization + tree merge) with a
flat-stream design that XLA compiles as whole-array work, with no atomics
and no data-dependent control flow:

1. **signed digits**: scalars are split into ceil(254/c) c-bit windows and
   rebalanced to digits in [-(2^(c-1)-1), 2^(c-1)] with carry propagation —
   half the buckets of the reference's unsigned windows (multiexp.hpp:4-6),
   paid for by a mask-negated y at gather time.
2. **one sort per window row, then compaction**: every (window, element)
   pair gets the flat bucket id window*NB + digit; zero digits take a
   sentinel that sorts to the row's tail, and one gather concatenates the
   rows' nonzero prefixes into a stream of `cap` entries (cap = next power
   of two >= the nonzero-digit count). Real keyless witnesses are ~94%
   bit-valued wires whose digits vanish in every window but the lowest, so
   compaction cuts the stream ~13x on the witness MSMs.
3. **lane scan**: V lanes walk the stream in L = chunk/V steps, each step
   one V-wide mixed add. The pre-add accumulator of every step is kept, so
   the total of a bucket run inside one lane is gathered by a position
   computed from the sorted keys alone — no bucket scatter.
4. **boundary merge**: runs crossing lane or chunk boundaries resolve in
   one segmented suffix sum over the lanes' head/tail partials.
5. **weighted bucket reduction**: sum_b b*B_b for all windows at once (the
   suffix-scan form of the reference's running sum, multiexp.cpp:132-180).
6. **horner over windows**: sum_w 2^(c*w) * W_w.

Digit-0 entries map to the point at infinity, so padding and zero scalars
need no special casing anywhere. G2 runs the same pipeline with Fq2
coordinates (alt_bn128.hpp:9-69's second Curve instantiation).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..curves.jacobian import JacobianCurve, JacPoint
from ..fields.limbs import LIMB_BITS, NUM_LIMBS

SCALAR_BITS = 254

# sequential lane-scan steps per stream chunk: the chunk's entries are
# spread over chunk // _SCAN_STEPS lanes, so each step is one wide batched
# mixed add
_SCAN_STEPS = 64


def extract_digits(scalars: jnp.ndarray, c: int) -> jnp.ndarray:
    """(n, 16) u32 standard-form scalars -> (n_windows, n) int32 c-bit digits."""
    n_windows = -(-SCALAR_BITS // c)
    outs = []
    mask = jnp.uint32((1 << c) - 1)
    for w in range(n_windows):
        lo = w * c
        li, off = lo // LIMB_BITS, lo % LIMB_BITS
        d = scalars[:, li] >> off
        if off + c > LIMB_BITS and li + 1 < NUM_LIMBS:
            d = d | (scalars[:, li + 1] << (LIMB_BITS - off))
        if off + c > 2 * LIMB_BITS and li + 2 < NUM_LIMBS:  # c > 16 never hits this
            d = d | (scalars[:, li + 2] << (2 * LIMB_BITS - off))
        outs.append((d & mask).astype(jnp.int32))
    return jnp.stack(outs)


def extract_digits_signed(scalars: jnp.ndarray, c: int):
    """Balanced signed digits: returns (keys, negs), both (n_windows, n) i32.

    scalar = sum_w (-1)^negs[w] * keys[w] * 2^(c*w), keys in [0, 2^(c-1)].
    Carry propagation never overflows the top window for canonical Fr
    scalars (< 2^254, and 254 mod c <= c-1). Verified against host ints in
    tests/test_msm.py.
    """
    d = extract_digits(scalars, c)
    half = 1 << (c - 1)
    full = 1 << c
    keys, negs = [], []
    carry = jnp.zeros_like(d[0])
    for w in range(d.shape[0]):
        dw = d[w] + carry
        neg = dw > half
        carry = neg.astype(jnp.int32)
        keys.append(jnp.where(neg, full - dw, dw))
        negs.append(neg.astype(jnp.int32))
    return jnp.stack(keys), jnp.stack(negs)


def _searchsorted(keys: jnp.ndarray, vals: jnp.ndarray) -> jnp.ndarray:
    """Left-bisect positions of `vals` in the 1-D sorted `keys` (lax-only:
    jnp.searchsorted's jitted wrapper trips the jax-0.9 closed_call
    lowering-cache bug when multiple MSM shapes trace in one process)."""
    m = keys.shape[0]

    def body(_, lohi):
        lo, hi = lohi
        done = lo >= hi
        mid = jnp.minimum((lo + hi) >> 1, m - 1)
        go = keys[mid] < vals
        lo2 = jnp.where(go, mid + 1, lo)
        hi2 = jnp.where(go, hi, mid)
        return (jnp.where(done, lo, lo2), jnp.where(done, hi, hi2))

    lo = jnp.zeros_like(vals)
    hi = jnp.full_like(vals, m)
    lo, _ = jax.lax.fori_loop(0, (m + 1).bit_length(), body, (lo, hi))
    return lo


def suffix_sum_points(curve: JacobianCurve, pts: JacPoint, keys=None, steps=None) -> JacPoint:
    """Inclusive suffix sums over the leading axis: out[i] = sum_{j >= i}
    pts[j], restricted to the run of equal `keys` when keys are given (then
    each run's first position holds the run total). `steps` (possibly a
    traced scalar) caps the Hillis-Steele passes; a run of length S needs
    ceil(log2(S))."""
    m = pts.x.shape[0]
    full = max(m - 1, 1).bit_length()
    steps = full if steps is None else jnp.minimum(steps, full)
    idx = jnp.arange(m)

    def body(s, acc):
        sh = jnp.left_shift(1, s)
        shifted = jax.tree.map(lambda a: jnp.roll(a, -sh, axis=0), acc)
        valid = idx < m - sh
        if keys is not None:
            valid = valid & (jnp.roll(keys, -sh) == keys)
        return curve.select(valid, curve.add(acc, JacPoint(*shifted)), acc)

    return jax.lax.fori_loop(0, steps, body, pts)


@functools.partial(jax.jit, static_argnames="curve")
def _msm_small(points_x, points_y, points_inf, scalars, *, curve) -> JacPoint:
    """Direct MSM for small n: batched double-and-add over all points at
    once (254 steps), then a log-depth tree sum."""
    n = scalars.shape[0]
    bit_idx = jnp.arange(SCALAR_BITS - 1, -1, -1)
    limb = bit_idx // LIMB_BITS
    off = bit_idx % LIMB_BITS
    bits = (scalars[:, limb] >> off) & 1  # (n, 254) MSB-first

    base = curve.from_affine(points_x, points_y, points_inf)

    def body(i, acc):
        acc = curve.dbl(acc)
        added = curve.add(acc, base)
        return curve.select(bits[:, i] == 1, added, acc)

    acc = jax.lax.fori_loop(0, SCALAR_BITS, body, curve.infinity((n,)))
    return tree_reduce_points(curve, acc, n)


def tree_reduce_points(curve: JacobianCurve, acc: JacPoint, m: int) -> JacPoint:
    """Sum of a leading-axis batch of Jacobian points via a suffix scan."""
    if m == 1:
        return JacPoint(*jax.tree.map(lambda a: a[0], acc))
    total = suffix_sum_points(curve, JacPoint(*jax.tree.map(lambda a: a[:m], acc)))
    return JacPoint(*jax.tree.map(lambda a: a[0], total))


def _p2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def window_bits(n: int) -> int:
    """Window size for dense (uniform) scalars: the lane scan costs one
    mixed add per stream entry, and the stream of ceil(254/c)*n entries
    pads to a power of two; the weighted reduction's log-step suffix scans
    cost ~3*c*2^(c-1) adds per window."""

    def cost(c: int) -> int:
        wn = -(-SCALAR_BITS // c)
        return _p2(wn * n) + wn * 3 * c * (1 << (c - 1))

    return min(range(4, 17), key=cost)


def _chunk_entries(curve: JacobianCurve) -> int:
    """Stream entries scanned per pass. Each entry keeps one 3-coordinate
    pre-add state: 2^23 G1 (or 2^22 G2) entries is ~1.6 GB transient."""
    return 1 << 23 if curve.ops.coord_ndim == 1 else 1 << 22


def _stream_shape(curve: JacobianCurve, scalars: jnp.ndarray, c: int) -> tuple:
    """(cap, chunk, lanes) of the flat stream for (B, n, 16) scalars, n a
    power of two.

    cap is the next power of two >= the nonzero-digit count, counted on the
    host, but at least 2n: every sparse stream over n rows (the witness
    MSMs hold ~2 nonzero digits per row) then gets the same cap, and with
    it the same compiled graph, across tables and requests. Under a trace
    (e.g. inside shard_map) the count is unknown and the stream is dense."""
    total = scalars.shape[0] * -(-SCALAR_BITS // c) * scalars.shape[1]
    if isinstance(scalars, jax.core.Tracer):
        cap = _p2(total)
    else:
        nnz = int(_count_nonzero_digits(scalars, c=c))
        cap = min(max(_p2(nnz), 2 * _p2(scalars.shape[1])), _p2(total))
    chunk = min(cap, _chunk_entries(curve))
    return cap, chunk, max(1, chunk // _SCAN_STEPS)


def msm(
    points_x: jnp.ndarray,
    points_y: jnp.ndarray,
    points_inf: jnp.ndarray,
    scalars: jnp.ndarray,
    *,
    curve: JacobianCurve,
    c: int | None = None,
    small_threshold: int = 128,
) -> JacPoint:
    """sum_i scalars[i] * P_i.  Points affine (Montgomery), scalars standard.

    Returns a single Jacobian point (batch shape ()). Tables may hold
    duplicate points and infinities: the group law is complete. `scalars`
    may be shorter than the table (missing rows count as zero).
    """
    if points_x.shape[0] <= small_threshold:
        scalars = _pad_to(scalars, points_x.shape[0], 0, 0)
        return _msm_small(points_x, points_y, points_inf, scalars, curve=curve)
    points_x, points_y, points_inf, scalars = _pad_rows(
        points_x, points_y, points_inf, scalars[None]
    )
    c = c or window_bits(scalars.shape[1])
    cap, chunk, v = _stream_shape(curve, scalars, c)
    return _msm_flat(
        points_x, points_y, points_inf, scalars[0],
        curve=curve, c=c, v=v, cap=cap, chunk=chunk,
    )


def _pad_to(a: jnp.ndarray, rows: int, axis: int, fill) -> jnp.ndarray:
    if a.shape[axis] == rows:
        return a
    width = [(0, 0)] * a.ndim
    width[axis] = (0, rows - a.shape[axis])
    return jnp.pad(a, width, constant_values=fill)


def pad_table(points_x, points_y, points_inf, rows: int) -> tuple:
    """A point table padded with infinity rows to `rows` rows."""
    return (
        _pad_to(points_x, rows, 0, 0),
        _pad_to(points_y, rows, 0, 0),
        _pad_to(points_inf, rows, 0, True),
    )


def _pad_rows(points_x, points_y, points_inf, scalars):
    """Pad the table to a power-of-two row count with infinity rows, and
    the (B, n, 16) scalars with zero rows to match, so MSMs over tables of
    similar size share one compiled graph."""
    rows = _p2(points_x.shape[0])
    return (*pad_table(points_x, points_y, points_inf, rows), _pad_to(scalars, rows, 1, 0))


def msm_batch(
    points_x: jnp.ndarray,
    points_y: jnp.ndarray,
    points_inf: jnp.ndarray,
    scalars: jnp.ndarray,
    *,
    curve: JacobianCurve,
    c: int | None = None,
) -> JacPoint:
    """B MSMs over ONE point table: scalars (B, n, 16) -> JacPoint stacked
    on a leading batch axis.

    One flat stream whose bucket ids carry a batch offset, i.e. one sort
    and one scan for the whole batch — not B serialized MSMs and not vmap
    (compaction needs the host-side nonzero count, which vmap cannot trace
    through). The BatchProver's device sweep lands here.
    """
    B = scalars.shape[0]
    if points_x.shape[0] <= 128 or B == 1:  # B == 1 reuses the single-MSM graphs
        singles = [
            msm(points_x, points_y, points_inf, scalars[b], curve=curve, c=c)
            for b in range(B)
        ]
        return JacPoint(*(jnp.stack(coord) for coord in zip(*singles)))
    points_x, points_y, points_inf, scalars = _pad_rows(
        points_x, points_y, points_inf, scalars
    )
    c = c or window_bits(scalars.shape[1])
    cap, chunk, v = _stream_shape(curve, scalars, c)
    return _msm_flat(
        points_x, points_y, points_inf, scalars,
        curve=curve, c=c, v=v, cap=cap, chunk=chunk, batch=B,
    )


@functools.partial(jax.jit, static_argnames="c")
def _count_nonzero_digits(scalars: jnp.ndarray, *, c: int) -> jnp.ndarray:
    """Total nonzero signed digits across a (B, n, 16) scalar batch (the
    compacted stream length before padding)."""
    keys, _ = jax.vmap(lambda s: extract_digits_signed(s, c))(scalars)
    return jnp.sum((keys >= 1).astype(jnp.int32))


def _lane_scan(curve: JacobianCurve, keys, idx, neg, px, py, pinf):
    """V lanes walk a slab-major (L, V) stream of bucket keys and point
    indices (rows of px/py/pinf), one mixed add per step.

    Returns (emits, head_key, head_pt, tail_key, tail_pt): emits[t] is the
    accumulator after slab t (for t < L-1), i.e. the total of a run that
    ends in slab t; head is the lane's first run (key -2: none closed),
    tail its still-open last run (key -1: the lane holds one run, which is
    then the head).
    """
    V = keys.shape[1]
    inf0 = curve.infinity((V,))

    def load(k, i, ng):
        x, y, q_inf = px[i], py[i], pinf[i]
        return k, x, curve.ops.select(ng, curve.ops.neg(y), y), q_inf

    k0, x0, y0, inf_0 = load(keys[0], idx[0], neg[0])
    state0 = (k0, curve.from_affine(x0, y0, inf_0), jnp.ones((V,), bool),
              jnp.full((V,), -2, jnp.int32), inf0)

    def step(state, slab):
        cur_key, acc, is_head, head_key, head_pt = state
        k, x, y, q_inf = load(*slab)
        same = k == cur_key
        to_head = ~same & is_head
        head_key = jnp.where(to_head, cur_key, head_key)
        head_pt = curve.select(to_head, acc, head_pt)
        is_head = is_head & same
        grown = curve.add_mixed(acc, x, y, q_inf)
        fresh = curve.from_affine(x, y, q_inf)
        return (k, curve.select(same, grown, fresh), is_head, head_key, head_pt), acc

    (k_last, acc, is_head, head_key, head_pt), emits = jax.lax.scan(
        step, state0, (keys[1:], idx[1:], neg[1:])
    )
    tail_key = jnp.where(is_head, -1, k_last)
    tail_pt = curve.select(is_head, inf0, acc)
    head_key = jnp.where(is_head, k_last, head_key)
    head_pt = curve.select(is_head, acc, head_pt)
    return emits, head_key, head_pt, tail_key, tail_pt


@functools.partial(
    jax.jit, static_argnames=("curve", "c", "v", "cap", "chunk", "batch")
)
def _msm_flat(
    points_x: jnp.ndarray,
    points_y: jnp.ndarray,
    points_inf: jnp.ndarray,
    scalars: jnp.ndarray,
    *,
    curve: JacobianCurve,
    c: int,
    v: int,
    cap: int,
    chunk: int,
    batch: int | None = None,
) -> JacPoint:
    """Flat-stream Pippenger (module docstring, steps 2-6).

    Every (batch, window, element) triple maps to one flat bucket id
    fb = (b*Wn + w)*NB + digit. The stream of `cap` entries runs in
    `chunk`-entry pieces (lax.scan carries the dense bucket table), each a
    lane scan with `v` lanes; chunk boundaries behave exactly like lane
    boundaries and resolve in the one global boundary merge.

    `batch=B` proves B scalar vectors (B, n, 16) against the SAME point
    table in one stream (the BatchProver's device sweep; the reference's
    mutex serializes here, prover_state.rs:21).
    """
    n = scalars.shape[-2]
    B = batch or 1
    V = v
    assert chunk % V == 0 and cap % chunk == 0, (cap, chunk, V)
    L = chunk // V
    n_chunks = cap // chunk

    # (B, Wn, n) digit planes; the unbatched call is B == 1
    keys, negs = jax.vmap(lambda s: extract_digits_signed(s, c))(
        scalars.reshape(B, n, scalars.shape[-1])
    )
    Wn = keys.shape[1]
    NB = (1 << (c - 1)) + 1
    rows = B * Wn
    n_seg = rows * NB
    assert n_seg + 1 < (1 << 31)

    # Sort PER (batch, window) ROW, then compact: a row-sorted (rows, n)
    # array concatenated in row order IS the flat stream sorted by bucket
    # id — no global sort needed. Zero digits and pads take the sentinel
    # key NB, which sorts to each row's tail.
    real = keys >= 1
    kr = jnp.where(real, keys, NB).reshape(rows, n)
    iota = jax.lax.iota(jnp.int32, n)[None, None, :]
    pr = jnp.where(real, iota | (negs << 30), n).reshape(rows, n)
    idx_bits = (n + 1).bit_length()
    key_bits = (NB + 1).bit_length()
    if key_bits + 1 + idx_bits <= 31:
        packed = (
            (kr << (idx_bits + 1))
            | (((pr >> 30) & 1) << idx_bits)
            | (pr & ((1 << idx_bits) - 1))
        )
        packed = jax.lax.sort(packed, dimension=1)
        kr_s = packed >> (idx_bits + 1)
        pr_s = (packed & ((1 << idx_bits) - 1)) | (
            ((packed >> idx_bits) & 1) << 30
        )
    else:
        kr_s, pr_s = jax.lax.sort(
            (kr, pr), num_keys=1, is_stable=False, dimension=1
        )

    if cap < rows * n:
        # compaction: output slot p maps to row rw = searchsorted(offs, p)-1,
        # local offset p - offs[rw]; p past the total real count clips to
        # the sentinel (bucket n_seg / point-table infinity row)
        nnz_rows = jnp.sum(real.reshape(rows, n), axis=1, dtype=jnp.int32)
        offs = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(nnz_rows, dtype=jnp.int32)]
        )
        pos_c = jax.lax.iota(jnp.int32, cap)
        # right-bisect(offs, p) == left-bisect(offs, p+1) over integer offsets
        rw = jnp.clip(_searchsorted(offs, pos_c + 1) - 1, 0, rows - 1)
        valid = pos_c < offs[rows]
        src = jnp.where(valid, rw * n + pos_c - jnp.take(offs, rw), 0)
        dig = jnp.take(kr_s.reshape(rows * n), src)
        fb_s = jnp.where(valid, rw * NB + dig, n_seg)
        pay_s = jnp.where(valid, jnp.take(pr_s.reshape(rows * n), src), n)
        row_base = offs[:-1]
    else:
        # dense stream (nnz ~= rows*n, e.g. the H MSM's uniform scalars):
        # the row-sorted planes ARE the stream. Row tails' sentinel digits
        # (NB) land in the next row's digit-0 bucket, which carries weight
        # 0 and gathers the infinity row, so they are no-ops.
        warr = jax.lax.iota(jnp.int32, rows)[:, None]
        fb_s = (warr * NB + kr_s).reshape(rows * n)
        pay_s = pr_s.reshape(rows * n)
        if cap > rows * n:
            fb_s = jnp.pad(fb_s, (0, cap - rows * n), constant_values=n_seg)
            pay_s = jnp.pad(pay_s, (0, cap - rows * n), constant_values=n)
        row_base = jax.lax.iota(jnp.int32, rows) * n

    # point table with a sentinel infinity row at index n
    def ext(a, fill):
        return jnp.concatenate([a, jnp.full((1, *a.shape[1:]), fill, a.dtype)])

    px, py, pinf = ext(points_x, 0), ext(points_y, 0), ext(points_inf, True)

    # bucket geometry from the sorted keys alone. Element at flat position
    # p lives in chunk p//chunk, lane (p//L) % V, slab p % L — p//L is a
    # GLOBAL lane id (chunks stack in the lane direction), so interior/span
    # tests are uniform across chunk boundaries. Bucket (rw, d) lives only
    # in row rw's span: counts of digits <= d in the sorted row give its
    # end, the count for d-1 its start. Dense-mode sentinel tails read as
    # empty here; they resolve through the boundary merge into a weight-0
    # bucket.
    q1 = jax.lax.iota(jnp.int32, NB) + 1
    cnt = jax.vmap(lambda row: _searchsorted(row, q1))(kr_s)
    cnt_prev = jnp.concatenate([jnp.zeros((rows, 1), jnp.int32), cnt[:, :-1]], axis=1)
    starts = (row_base[:, None] + cnt_prev).reshape(n_seg)
    ends = (row_base[:, None] + cnt - 1).reshape(n_seg)
    interior = (
        (ends >= starts)
        & (starts // L == ends // L)
        & (starts % L != 0)
        & (ends % L != L - 1)
    )
    # a bucket spanning S lanes occupies <= 2S consecutive boundary slots,
    # so ceil(log2(2*max_span)) merge passes suffice
    lane_span = ends // L - starts // L + 1  # negative for empty buckets
    merge_steps = 32 - jax.lax.clz(2 * jnp.maximum(jnp.max(lane_span), 1) - 1)

    def chunk_body(tbl, sl):
        kw, pw, ci = sl

        def smaj(x):  # (chunk,) -> (L, V) slab-major
            return x.reshape(V, L).T

        emits, hk, hp, tk, tp = _lane_scan(
            curve, smaj(kw), smaj(pw & ((1 << 30) - 1)), smaj((pw >> 30) == 1),
            px, py, pinf,
        )
        # interior-run totals for buckets ending in THIS chunk: the run
        # [s, e] total is the accumulator after slab e%L in lane e//L
        mine = interior & (ends // chunk == ci)
        e_loc = ends - ci * chunk
        eidx = jnp.where(mine, (e_loc % L) * V + e_loc // L, 0)
        src = jax.tree.map(lambda a: ext(a.reshape(-1, *a.shape[2:]), 0)[eidx], emits)
        return curve.select(mine, JacPoint(*src), tbl), (hk, hp, tk, tp)

    (tbl, (hks, hps, tks, tps)) = jax.lax.scan(
        chunk_body,
        curve.infinity((n_seg,)),
        (
            fb_s.reshape(n_chunks, chunk),
            pay_s.reshape(n_chunks, chunk),
            jax.lax.iota(jnp.int32, n_chunks),
        ),
    )

    # one global boundary sequence: (head, tail) per global lane, in order;
    # -2/-1 sentinels take the previous key (their points are infinity)
    m2 = 2 * V * n_chunks
    bkeys = jax.lax.cummax(jnp.stack([hks, tks], axis=2).reshape(m2))
    bpts = JacPoint(*jax.tree.map(
        lambda h, t: jnp.stack([h, t], axis=2).reshape(m2, *h.shape[2:]), hps, tps
    ))
    merged = suffix_sum_points(curve, bpts, keys=bkeys, steps=merge_steps)

    # overlay cross-lane bucket totals from the merged run leaders
    bclip = jnp.clip(bkeys, 0, n_seg)
    lpos = jax.ops.segment_min(
        jax.lax.iota(jnp.int32, m2), bclip, n_seg + 1, indices_are_sorted=True
    )[:n_seg]
    has = (lpos < m2) & ~interior
    midx = jnp.where(has, jnp.minimum(lpos, m2 - 1), 0)
    tbl = curve.select(has, JacPoint(*(a[midx] for a in merged)), tbl)

    # (rows*NB, ...) -> (rows, NB, ...) dense tables -> weighted reduction
    # of all rows at once, then one horner per batch element
    dense = JacPoint(*(a.reshape(rows, NB, *a.shape[1:]) for a in tbl))
    wins = jax.vmap(lambda bk: _weighted_bucket_total(curve, bk, NB))(dense)
    outs = [
        _horner_windows(
            curve, JacPoint(*(a[b * Wn : (b + 1) * Wn] for a in wins)), Wn, c
        )
        for b in range(B)
    ]
    if batch is None:
        return outs[0]
    return JacPoint(*(jnp.stack(c_) for c_ in zip(*outs)))


def _weighted_bucket_total(curve: JacobianCurve, buckets: JacPoint, n_buckets: int) -> JacPoint:
    """sum_{b>=1} b * B_b (the reference's running sum, multiexp.cpp:132-180)
    as two log-depth suffix scans: S_b = sum_{j>=b} B_j, then the sum of
    S_b over b >= 1. Both scans run as ONE loop, so the group law is traced
    once."""
    m = n_buckets
    steps = max(m - 1, 1).bit_length()
    idx = jnp.arange(m)
    inf = curve.infinity((m,))

    def body(s, acc):
        # the second scan starts on S with bucket 0 dropped
        acc = curve.select((idx == 0) & (s == steps), inf, acc)
        sh = jnp.left_shift(1, s % steps)
        shifted = jax.tree.map(lambda a: jnp.roll(a, -sh, axis=0), acc)
        return curve.select(idx < m - sh, curve.add(acc, JacPoint(*shifted)), acc)

    bk = JacPoint(*jax.tree.map(lambda a: a[:m], buckets))
    out = jax.lax.fori_loop(0, 2 * steps, body, bk)
    return JacPoint(*jax.tree.map(lambda a: a[0], out))


def _horner_windows(curve: JacobianCurve, wins: JacPoint, n_windows: int, c: int) -> JacPoint:
    """acc = 2^c * acc + W_w from the highest window down, loop-rolled."""

    def win(w):
        return JacPoint(
            *jax.tree.map(
                lambda a: jax.lax.dynamic_index_in_dim(a, w, axis=0, keepdims=False),
                wins,
            )
        )

    def horner(t, acc):
        acc = jax.lax.fori_loop(0, c, lambda _, a: curve.dbl(a), acc)
        return curve.add(acc, win(n_windows - 2 - t))

    return jax.lax.fori_loop(0, n_windows - 1, horner, win(n_windows - 1))

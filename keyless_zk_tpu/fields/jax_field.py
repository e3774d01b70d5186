"""Batched prime-field arithmetic in plain JAX.

Replaces the reference's x86-64 asm field layer (rust-rapidsnark
src/asm/fr.asm, fq.asm and the generic C++ fallbacks fr_generic.cpp /
fq_generic.cpp) with a batched, data-parallel design:

- an element is 16 little-endian limbs of 16 bits held in uint32 lanes
  (see fields/limbs.py for why);
- every op is *batched*: inputs have shape (..., 16) and all arithmetic is
  elementwise across the leading batch dims, so XLA fuses the whole limb
  schedule into wide vector code;
- multiplication is **parallel Montgomery**: one full limb convolution
  T = a*b, then m = T * (-p^-1 mod R) mod R as a second convolution, then
  (T + m*p)/R as a third — no sequential limb recurrence anywhere, unlike
  CIOS/SOS. 16x16-bit products are exact in uint32 and columns accumulate
  <= 32 terms (< 2^22), far below the u32 ceiling;
- carry propagation is a Kogge-Stone carry-lookahead scan over the limb
  axis (log passes), not a sequential ripple, so the whole multiply is
  ~100 XLA ops of straight-line vector code;
- there is no data-dependent control flow — zero/overflow handling is by
  masks — so everything jits cleanly.

Semantics match the reference at the value level: Montgomery form with
R = 2^256, canonical reduction to [0, p). Differential-tested against the
pure-python model in tests/test_field.py.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

import jax
import jax.numpy as jnp

from . import bn254
from .limbs import LIMB_BITS, LIMB_MASK, NUM_LIMBS, int_to_limbs

# numpy scalar, NOT jnp: a jnp scalar here would initialise the XLA backend
# at import time, which breaks jax.distributed.initialize() (it must run
# before any backend init) for anyone importing this module first.
MASK = np.uint32(LIMB_MASK)


@dataclass(frozen=True, eq=False)
class FieldSpec:
    """Host-side description of a prime field in limb form."""

    name: str
    p: int
    p_limbs: np.ndarray = field(init=False)
    n0_limbs: np.ndarray = field(init=False)  # -p^-1 mod 2^256 (full width)
    r_mod_p: int = field(init=False)  # R = 2^256 mod p  (Montgomery one)
    r2_mod_p: int = field(init=False)  # R^2 mod p
    r_inv: int = field(init=False)  # R^-1 mod p

    def __hash__(self):  # usable as a jit static arg
        return hash((self.name, self.p))

    def __eq__(self, other):
        return isinstance(other, FieldSpec) and (self.name, self.p) == (other.name, other.p)

    def __post_init__(self):
        object.__setattr__(self, "p_limbs", int_to_limbs(self.p))
        R = 1 << (LIMB_BITS * NUM_LIMBS)
        object.__setattr__(self, "n0_limbs", int_to_limbs((-pow(self.p, -1, R)) % R))
        object.__setattr__(self, "r_mod_p", R % self.p)
        object.__setattr__(self, "r2_mod_p", (R * R) % self.p)
        object.__setattr__(self, "r_inv", pow(R, -1, self.p))

    # ---- host-side scalar helpers (python ints) ----
    def to_mont_int(self, x: int) -> int:
        return (x << (LIMB_BITS * NUM_LIMBS)) % self.p

    def from_mont_int(self, x: int) -> int:
        return (x * self.r_inv) % self.p


FQ = FieldSpec("fq", bn254.Q)
FR = FieldSpec("fr", bn254.R_SCALAR)


def _const(spec_limbs: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(spec_limbs, dtype=jnp.uint32)


def zeros(shape=(), spec: FieldSpec = FQ) -> jnp.ndarray:
    return jnp.zeros((*shape, NUM_LIMBS), dtype=jnp.uint32)


def consts(spec: FieldSpec, value: int, shape=()) -> jnp.ndarray:
    """Broadcast a host int (already in the desired representation) to a batch."""
    v = _const(int_to_limbs(value % spec.p))
    return jnp.broadcast_to(v, (*shape, NUM_LIMBS))


# ---- carry machinery (all parallel over the limb axis) ---------------------

def _shift_limbs(x: jnp.ndarray, s: int, fill: int = 0) -> jnp.ndarray:
    """Shift limb vector toward higher indices by s, filling with `fill`."""
    if s == 0:
        return x
    pad = jnp.full((*x.shape[:-1], s), fill, dtype=x.dtype)
    return jnp.concatenate([pad, x[..., :-s]], axis=-1)


def _carry_finish(v: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Exact carry resolution for limbs with values <= 2^16 (17 bits).

    Kogge-Stone carry-lookahead over the limb axis: a limb generates a carry
    iff v == 2^16 and propagates iff its low 16 bits are all ones. Returns
    (normalized limbs, total carry-out).
    """
    n = v.shape[-1]
    g = v >> LIMB_BITS  # 0/1
    pr = ((v & MASK) == MASK).astype(jnp.uint32)
    s = 1
    while s < n:
        g = g | (pr & _shift_limbs(g, s, 0))
        pr = pr & _shift_limbs(pr, s, 1)
        s <<= 1
    carry_in = _shift_limbs(g, 1, 0)
    out = (v + carry_in) & MASK
    return out, g[..., n - 1]


def _normalize(cols: jnp.ndarray, out_limbs: int) -> jnp.ndarray:
    """Columns of 16-bit weight with values < 2^22 -> canonical 16-bit limbs.

    Carries beyond `out_limbs` are dropped (result is mod 2^(16*out_limbs)).
    Two compression passes bring every column to <= 2^16; Kogge-Stone
    resolves the remaining 0/1 chain exactly.
    """
    if cols.shape[-1] < out_limbs:
        pad = out_limbs - cols.shape[-1]
        cols = jnp.concatenate(
            [cols, jnp.zeros((*cols.shape[:-1], pad), cols.dtype)], axis=-1
        )
    cols = cols[..., :out_limbs]
    v = (cols & MASK) + _shift_limbs(cols >> LIMB_BITS, 1)  # < 2^16 + 2^6
    v = (v & MASK) + _shift_limbs(v >> LIMB_BITS, 1)  # <= 2^16
    out, _ = _carry_finish(v)
    return out


@functools.lru_cache(maxsize=16)
def _conv_onehots(l_a: int, l_b: int, out_cols: int) -> tuple[np.ndarray, np.ndarray]:
    """One-hot tensors mapping outer-product entries to convolution columns.

    T0[i,j,k] = [i+j == k] routes the low half of each 16x16-bit product,
    T1 routes the high half (weight 2^16 -> column i+j+1).
    """
    t0 = np.zeros((l_a, l_b, out_cols), dtype=np.uint32)
    t1 = np.zeros((l_a, l_b, out_cols), dtype=np.uint32)
    for i in range(l_a):
        for j in range(l_b):
            if i + j < out_cols:
                t0[i, j, i + j] = 1
            if i + j + 1 < out_cols:
                t1[i, j, i + j + 1] = 1
    return t0, t1


def _product_cols(a: jnp.ndarray, b: jnp.ndarray, out_cols: int) -> jnp.ndarray:
    """Schoolbook limb convolution of canonical limb vectors.

    (..., L) x (..., L) -> (..., out_cols) u32 columns of 16-bit weight.
    Exact: 16x16-bit products fit u32; each column accumulates <= 2L terms
    of < 2^16, so columns stay < 2^21. Expressed as one outer product plus
    two one-hot contractions — 3 fat XLA ops instead of a ~100-op
    pad/concat chain, which keeps XLA:CPU compile times sane.

    The contractions run as f32 dot_generals, which XLA hands to its GEMM
    libraries. This is exact: every accumulated value is an integer
    < 2^21, far inside f32's 2^24 exact-integer range. HIGHEST precision is
    what keeps it exact: it forbids reduced-precision (bf16 or TF32) input
    rounding, which would drop low bits of values above 2^11.
    """
    o = a[..., :, None] * b[..., None, :]  # (..., L, L) u32, exact
    t0, t1 = _conv_onehots(a.shape[-1], b.shape[-1], out_cols)
    lo = jnp.einsum(
        "...ij,ijk->...k",
        (o & MASK).astype(jnp.float32),
        jnp.asarray(t0, dtype=jnp.float32),
        precision=jax.lax.Precision.HIGHEST,
    )
    hi = jnp.einsum(
        "...ij,ijk->...k",
        (o >> LIMB_BITS).astype(jnp.float32),
        jnp.asarray(t1, dtype=jnp.float32),
        precision=jax.lax.Precision.HIGHEST,
    )
    return lo.astype(jnp.uint32) + hi.astype(jnp.uint32)


# ---- field ops -------------------------------------------------------------

def _add_with_carry(v: jnp.ndarray, plus_one: bool) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Normalize n columns (< 2^17 each) to n limbs + 0/1 carry-out.

    Works over n+1 limbs so the top column's carry is not lost.
    """
    n = v.shape[-1]
    v = jnp.concatenate([v, jnp.zeros((*v.shape[:-1], 1), v.dtype)], axis=-1)
    if plus_one:
        v = v.at[..., 0].add(1)
    v = (v & MASK) + _shift_limbs(v >> LIMB_BITS, 1)
    out, _ = _carry_finish(v)
    return out[..., :n], out[..., n]


def _csub_p(limbs: jnp.ndarray, spec: FieldSpec) -> jnp.ndarray:
    """Conditionally subtract p: canonical input < 2p, output < p."""
    pbar = _const((LIMB_MASK - spec.p_limbs.astype(np.int64)).astype(np.uint32))
    out, carry = _add_with_carry(limbs + pbar, plus_one=True)
    return jnp.where((carry >= 1)[..., None], out, limbs)


@functools.partial(jax.jit, static_argnames="spec")
def add(a: jnp.ndarray, b: jnp.ndarray, spec: FieldSpec) -> jnp.ndarray:
    """(a + b) mod p for canonical inputs in [0, p)."""
    limbs = _normalize(a + b, NUM_LIMBS)  # a+b < 2p < 2^256: no carry-out
    return _csub_p(limbs, spec)


@functools.partial(jax.jit, static_argnames="spec")
def sub(a: jnp.ndarray, b: jnp.ndarray, spec: FieldSpec) -> jnp.ndarray:
    """(a - b) mod p for canonical inputs in [0, p)."""
    d, carry = _add_with_carry(a + (MASK - b), plus_one=True)  # carry <=> a >= b
    p_row = _const(spec.p_limbs)
    # wrapped case: d == a - b + 2^256; adding p and dropping 2^256 fixes it
    d2, _ = _add_with_carry(d + p_row, plus_one=False)
    return jnp.where((carry >= 1)[..., None], d, d2)


def neg(a: jnp.ndarray, spec: FieldSpec) -> jnp.ndarray:
    """(-a) mod p; maps 0 to 0."""
    return jnp.where(is_zero(a)[..., None], a, sub(consts(spec, 0, ()), a, spec))


def is_zero(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.all(a == 0, axis=-1)


def eq(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.all(a == b, axis=-1)


def select(mask: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """mask ? a : b, with mask of batch shape (no limb dim)."""
    return jnp.where(mask[..., None], a, b)


def _redc(t: jnp.ndarray, spec: FieldSpec) -> jnp.ndarray:
    """Montgomery reduction: t (canonical 32-limb, value < p*R) -> t*R^-1 mod p.

        m = t * (-p^-1) mod R        (16-limb low convolution)
        out = (t + m*p) / R          (exact division: low limbs vanish)
    Result < 2p, one conditional subtract.
    """
    n0 = _const(spec.n0_limbs)
    p_row = _const(spec.p_limbs)
    t_lo = t[..., :NUM_LIMBS]
    m = _normalize(_product_cols(t_lo, jnp.broadcast_to(n0, t_lo.shape), NUM_LIMBS), NUM_LIMBS)
    mp = _product_cols(m, jnp.broadcast_to(p_row, m.shape), 2 * NUM_LIMBS + 1)
    s = mp + jnp.pad(t, [(0, 0)] * (t.ndim - 1) + [(0, 1)])  # cols < 2^22
    s = _normalize(s, 2 * NUM_LIMBS + 1)
    # t + m*p ≡ 0 mod R exactly, so the low 16 limbs are zero: divide by R.
    limbs = s[..., NUM_LIMBS : 2 * NUM_LIMBS]  # (t + m*p)/R < 2p fits 16 limbs
    return _csub_p(limbs, spec)


@functools.partial(jax.jit, static_argnames="spec")
def mont_mul(a: jnp.ndarray, b: jnp.ndarray, spec: FieldSpec) -> jnp.ndarray:
    """Montgomery product a*b*R^-1 mod p, canonical in/out.

    Parallel (redundant-arithmetic) Montgomery: one full limb convolution
    T = a*b, then the REDC tail — no sequential limb recurrence anywhere.
    """
    t = _normalize(_product_cols(a, b, 2 * NUM_LIMBS + 1), 2 * NUM_LIMBS)
    return _redc(t, spec)


@functools.partial(jax.jit, static_argnames=("spec", "num_segments"))
def segment_sum_mod(
    values: jnp.ndarray,
    segment_ids: jnp.ndarray,
    num_segments: int,
    spec: FieldSpec,
) -> jnp.ndarray:
    """Race-free modular scatter-add: out[k] = sum_{segment_ids[i]==k} values[i].

    Replacement for the reference's spinlock-guarded coefficient
    scatter (groth16.cpp:135-156): limbs are split into 8-bit halves and
    accumulated with plain integer segment sums (exact for < 2^23 terms per
    segment), then each wide row is folded back to canonical form with one
    Montgomery reduction.

    NOTE the output is scaled by R^-1 (the REDC factor): pre-scale `values`
    by R (e.g. multiply the static coefficient table by R^2 once at load
    time) so the result comes out in the intended representation.
    """
    assert values.shape[0] < (1 << 23), "segment_sum_mod: too many terms"
    lo, hi = split8(values)
    sum_lo = jax.ops.segment_sum(lo, segment_ids, num_segments)  # < 2^31
    sum_hi = jax.ops.segment_sum(hi, segment_ids, num_segments)
    return fold_split8_mod(sum_lo, sum_hi, spec)


@functools.partial(jax.jit, static_argnames="spec")
def sorted_segment_sum_mod(
    values: jnp.ndarray,
    bounds: jnp.ndarray,
    spec: FieldSpec,
) -> jnp.ndarray:
    """Segment sums of a PRE-SORTED value sequence partitioned by `bounds`
    (k+1 ascending positions): out[k] = sum(values[bounds[k]:bounds[k+1]])
    mod p (scaled by R^-1, same convention as segment_sum_mod).

    Replaces jax.ops.segment_sum for the static-boundary cases (zkey
    coefficient rows, dedup merge groups) with dense work and no
    scatter-add: cumsum + ONE boundary gather + shifted difference (the
    adjacent segments share their boundaries, so one gather serves both
    ends). Exactness: 8-bit column splits keep every cumulative sum
    < 2^32 for < 2^24 rows, and each out[k] difference is a < 2^23-term
    segment total (< 2^31).
    """
    assert values.shape[0] < (1 << 24), "sorted_segment_sum_mod: too many rows"
    lo, hi = split8(values)
    zs = jnp.zeros((1, values.shape[-1]), jnp.uint32)
    slo = jnp.concatenate([zs, jnp.cumsum(lo, axis=0, dtype=jnp.uint32)])
    shi = jnp.concatenate([zs, jnp.cumsum(hi, axis=0, dtype=jnp.uint32)])
    blo = jnp.take(slo, bounds, axis=0)
    bhi = jnp.take(shi, bounds, axis=0)
    return fold_split8_mod(blo[1:] - blo[:-1], bhi[1:] - bhi[:-1], spec)


def split8(values: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(..., 16) u32 16-bit limbs -> (lo, hi) 8-bit halves as u32, for exact
    integer accumulation (terms <= 255 per column)."""
    lo = (values & jnp.uint32(0xFF)).astype(jnp.uint32)
    hi = (values >> 8).astype(jnp.uint32)
    return lo, hi


@functools.partial(jax.jit, static_argnames="spec")
def fold_split8_mod(sum_lo: jnp.ndarray, sum_hi: jnp.ndarray, spec: FieldSpec) -> jnp.ndarray:
    """Fold accumulated 8-bit-split column sums (< 2^31 per column) back to
    canonical limbs mod p. Output scaled by R^-1 (one REDC), matching
    segment_sum_mod's convention."""
    # wide row value = sum_lo . 2^16-weights + sum_hi . 2^16-weights . 2^8
    # decompose every u32 column into 16-bit digits at the right positions
    ext = 2 * NUM_LIMBS  # plenty: value < 2^23 * p < 2^278
    cols = jnp.zeros((*sum_lo.shape[:-1], ext), dtype=jnp.uint32)

    def scatter(cols, arr, limb_offset):
        pad_cfg = [(0, 0)] * (arr.ndim - 1)
        arr = jnp.pad(arr, pad_cfg + [(limb_offset, ext - NUM_LIMBS - limb_offset)])
        return cols + arr

    # sum_lo = d0 + 2^16 d1
    cols = scatter(cols, sum_lo & MASK, 0)
    cols = scatter(cols, sum_lo >> LIMB_BITS, 1)
    # sum_hi * 2^8 = (hi & 0xFF) 2^8 + ((hi >> 8) & 0xFFFF) 2^16 + (hi >> 24) 2^32
    cols = scatter(cols, (sum_hi & jnp.uint32(0xFF)) << 8, 0)
    cols = scatter(cols, (sum_hi >> 8) & MASK, 1)
    cols = scatter(cols, sum_hi >> 24, 2)
    # columns < 5 * 2^16 < 2^22: _normalize handles them exactly
    t = _normalize(cols, ext)
    return _redc(t, spec)


def to_mont(a: jnp.ndarray, spec: FieldSpec) -> jnp.ndarray:
    return mont_mul(a, consts(spec, spec.r2_mod_p, ()), spec)


def from_mont(a: jnp.ndarray, spec: FieldSpec) -> jnp.ndarray:
    return mont_mul(a, consts(spec, 1, ()), spec)


@functools.partial(jax.jit, static_argnames=("e", "spec"))
def mont_pow(a: jnp.ndarray, e: int, spec: FieldSpec) -> jnp.ndarray:
    """a^e with a in Montgomery form (output Montgomery), e a host int.

    MSB-first square-and-multiply under lax.fori_loop so the limb schedule is
    traced once regardless of the 254-bit exponent.
    """
    nbits = max(e.bit_length(), 1)
    bits = jnp.asarray([(e >> (nbits - 1 - i)) & 1 for i in range(nbits)], dtype=jnp.uint32)
    one = jnp.broadcast_to(consts(spec, spec.r_mod_p, ()), a.shape)

    def body(i, acc):
        acc = mont_mul(acc, acc, spec)
        mul = mont_mul(acc, a, spec)
        return select(bits[i] == 1, mul, acc)

    return jax.lax.fori_loop(0, nbits, body, one)


def mont_inv(a: jnp.ndarray, spec: FieldSpec) -> jnp.ndarray:
    """a^-1 in Montgomery form via Fermat (a^(p-2)); 0 maps to 0."""
    return mont_pow(a, spec.p - 2, spec)


# ---- host-side conversions -------------------------------------------------

def encode_ints(xs, spec: FieldSpec, mont: bool = False) -> jnp.ndarray:
    """Host ints -> device limb batch, optionally into Montgomery form."""
    from .limbs import ints_to_limbs

    if mont:
        xs = [spec.to_mont_int(x % spec.p) for x in xs]
    else:
        xs = [x % spec.p for x in xs]
    return jnp.asarray(ints_to_limbs(xs), dtype=jnp.uint32)


def decode_ints(arr, spec: FieldSpec, mont: bool = False) -> list[int]:
    """Device limb batch -> host ints, optionally out of Montgomery form."""
    from .limbs import limbs_to_ints

    vals = limbs_to_ints(np.asarray(arr))
    if mont:
        vals = [spec.from_mont_int(v) for v in vals]
    return vals

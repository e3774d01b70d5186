"""Groth16 prover — JAX orchestration of the device kernels.

Re-design of the reference's C++ prover
(rust-rapidsnark/rapidsnark/src/groth16.cpp:41-360):

  1. four MSMs over the witness (A, B1, C on G1; B2 on G2)   [ops/msm.py]
  2. coefficient scatter into the a/b evaluation vectors — the reference's
     1024-spinlock scatter (groth16.cpp:135-156) becomes a race-free
     `segment_sum_mod` (sorted segment reduction)
  3. c = a*b; three (iNTT -> coset shift -> NTT) pipelines    [ops/ntt.py]
  4. h = (a*b - c) * R^-1, MSM over the H point table
  5. host-side tail: blind with r,s and assemble pi_a/pi_b/pi_c
     (groth16.cpp:288-353)

Representation note: we run the polynomial phase in exactly the reference's
"raw byte" space — zkey coefficients are Montgomery-stored, witness values
standard — so every intermediate equals rapidsnark's bit-for-bit and the
final MSM_H scalars match what the snarkjs H-point basis expects. The coef
table is pre-scaled by R^2 at load time so `segment_sum_mod`'s REDC factor
cancels (see its docstring).
"""

from __future__ import annotations

import functools
import secrets
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..curves import ref_curve
from ..curves.jacobian import G1_CURVE, G2_CURVE, JacPoint
from ..fields import bn254
from ..fields import jax_field as jf
from ..fields.jax_field import FR
from ..fields.limbs import NUM_LIMBS
from ..ops.msm import msm, pad_table
from ..ops.ntt import get_plan
from .zkey import ProvingKey


@dataclass
class Proof:
    """Proof points in standard-form host ints, snarkjs shapes."""

    pi_a: tuple
    pi_b: tuple
    pi_c: tuple

    def to_json_dict(self) -> dict:
        """snarkjs proof JSON — exact shape of reference groth16.cpp:362-410."""
        return {
            "pi_a": [str(self.pi_a[0]), str(self.pi_a[1]), "1"],
            "pi_b": [
                [str(self.pi_b[0][0]), str(self.pi_b[0][1])],
                [str(self.pi_b[1][0]), str(self.pi_b[1][1])],
                ["1", "0"],
            ],
            "pi_c": [str(self.pi_c[0]), str(self.pi_c[1]), "1"],
            "protocol": "groth16",
        }


# coefficient-table entries evaluated per device pass (~260 MB of limb data
# per slice; the full keyless table is ~42.7M entries)
_COEF_CHUNK = 1 << 22

# window bits for the four WITNESS MSMs. Their scalars are ~94% bit-valued
# (digits only in window 0), so nnz — and with it the scan/sort/gather
# stream — is nearly c-independent, while the dense bucket-table costs
# (table gathers, weighted reduction) scale with ceil(254/c)*2^(c-1). The
# H MSM's uniform scalars keep the default window_bits choice.
_SPARSE_C = 12


@functools.partial(jax.jit, static_argnames="m2")
def _eval_ab_fused(
    witness: jnp.ndarray,
    coef_s: jnp.ndarray,
    coef_val: jnp.ndarray,
    bounds: jnp.ndarray,
    d_los: jnp.ndarray,
    *,
    m2: int,
) -> jnp.ndarray:
    """witness -> concatenated a|b evaluation vectors (m2, 16).

    The sorted coef table streams in (k, _COEF_CHUNK) slices under one
    lax.scan, so the graph holds one chunk body whatever k is. Each chunk
    reduces via cumsum + one boundary gather (no scatter anywhere) and
    adds its W rows into the accumulator at row d_los[ci] (exact: each
    dest row holds < 2^23 8-bit terms). `bounds` (k, W+1) pads each
    chunk's segment boundaries with its last one, so the padded rows add
    zero; the accumulator carries W spare rows so the slice never clips.
    Tables arrive as ARGUMENTS — closing over them capture-compiles
    multi-GB constants into the executable.
    Replaces the reference's 1024-spinlock scatter (groth16.cpp:135-156).
    """
    w = bounds.shape[1] - 1
    zs = jnp.zeros((1, NUM_LIMBS), jnp.uint32)

    def chunk(acc, sl):
        s_idx, vals, bnd, d_lo = sl
        av = jf.mont_mul(jnp.take(witness, s_idx, axis=0), vals, FR)
        out = []
        for a, part in zip(acc, jf.split8(av)):
            cum = jnp.concatenate([zs, jnp.cumsum(part, axis=0, dtype=jnp.uint32)])
            # adjacent segments share boundaries, so ONE gather of the
            # bounds + a shifted difference gives every row's sum
            b = jnp.take(cum, bnd, axis=0)
            rows = jax.lax.dynamic_slice_in_dim(a, d_lo, w) + (b[1:] - b[:-1])
            out.append(jax.lax.dynamic_update_slice_in_dim(a, rows, d_lo, 0))
        return tuple(out), None

    acc0 = (jnp.zeros((m2 + w, NUM_LIMBS), jnp.uint32),) * 2
    (acc_lo, acc_hi), _ = jax.lax.scan(chunk, acc0, (coef_s, coef_val, bounds, d_los))
    return jf.fold_split8_mod(acc_lo[:m2], acc_hi[:m2], FR)


def _dedup_point_table(x: np.ndarray, y: np.ndarray, inf: np.ndarray):
    """Collapse duplicate rows of a zkey point table.

    Real zkeys repeat points heavily — in the full keyless setup points_a
    holds 1,377,553 rows but only 1,194,986 distinct (x, y, inf) triples
    and points_b1/b2 only 796,854 (mostly wires absent from B => infinity,
    plus genuinely equal evaluation points [A_i(tau)]). The prover sums the
    duplicate rows' witness scalars instead: MSM over unique points only —
    correct by bilinearity, and 13-42% less MSM work.

    Returns ((ux, uy, uinf), merge) where merge is None when the table has
    no duplicates, else (order, seg, n_unique) host arrays for a sorted
    segment-sum of scalars (out[k] = sum of scalars whose row maps to k).
    """
    n = inf.shape[0]
    flat = np.concatenate(
        [
            np.ascontiguousarray(x).reshape(n, -1),
            np.ascontiguousarray(y).reshape(n, -1),
            inf.reshape(n, 1).astype(x.dtype),
        ],
        axis=1,
    )
    view = np.ascontiguousarray(flat).view([("", flat.dtype)] * flat.shape[1])
    _, first_idx, inv = np.unique(view.ravel(), return_index=True, return_inverse=True)
    n_unique = first_idx.shape[0]
    if n_unique == n:
        return (x, y, inf), None
    order = np.argsort(inv, kind="stable").astype(np.int32)
    seg = inv[order].astype(np.int32)
    # static segment boundaries for the sorted cumsum-diff reduction
    bounds = np.searchsorted(seg, np.arange(n_unique + 1)).astype(np.int32)
    return (
        (x[first_idx], y[first_idx], inf[first_idx]),
        (order, bounds, int(n_unique)),
    )


def _sample_fr() -> int:
    """Rejection-sample a uniform scalar < r (groth16.cpp:288-316)."""
    while True:
        v = int.from_bytes(secrets.token_bytes(32), "little") & ((1 << 254) - 1)
        if v < bn254.R_SCALAR:
            return v


class Groth16Prover:
    """Device-resident proving key + jitted prove pipeline.

    Plays the role of the reference's FullProver/Prover pair
    (fullprover.cpp:136-181, groth16.cpp:41-360): construct once per zkey,
    call :meth:`prove` per witness.
    """

    def __init__(self, pk: ProvingKey):
        if pk.q != bn254.Q or pk.r != bn254.R_SCALAR:
            raise ValueError("zkey curve is not BN254")  # fullprover.cpp:154-158
        self.pk = pk
        self.domain_pow = (pk.domain_size - 1).bit_length()
        if (1 << self.domain_pow) != pk.domain_size:
            raise ValueError("domain size must be a power of two")
        self.plan = get_plan(self.domain_pow)

        dev = jnp.asarray

        def dedup_dev(x, y, inf):
            (ux, uy, uinf), merge = _dedup_point_table(x, y, inf)
            if merge is not None:
                order, bounds, nu = merge
                merge = (dev(order), dev(bounds), nu)
            return (dev(ux), dev(uy), dev(uinf)), merge

        self.points_a, self._merge_a = dedup_dev(
            pk.points_a.x, pk.points_a.y, pk.points_a.inf
        )
        self.points_b1, self._merge_b1 = dedup_dev(
            pk.points_b1.x, pk.points_b1.y, pk.points_b1.inf
        )
        self.points_b2, self._merge_b2 = dedup_dev(
            pk.points_b2.x, pk.points_b2.y, pk.points_b2.inf
        )
        # Front-pad the C table with nPublic+1 infinity rows: pointsC[i]
        # pairs with wtns[i + nPublic + 1] (groth16.cpp:104-112), so after
        # padding, table row i pairs with wtns[i] and MSM_C shares
        # MSM_A/B1's shape — one compiled kernel for all three.
        pad_c = pk.n_vars - pk.points_c.x.shape[0]
        self.points_c, self._merge_c = dedup_dev(
            np.pad(pk.points_c.x, [(pad_c, 0), (0, 0)]),
            np.pad(pk.points_c.y, [(pad_c, 0), (0, 0)]),
            np.pad(pk.points_c.inf, [(pad_c, 0)], constant_values=True),
        )
        self.points_h, self._merge_h = dedup_dev(
            pk.points_h.x, pk.points_h.y, pk.points_h.inf
        )
        # the three G1 witness tables share one row count, so their MSMs
        # share one compiled graph (msm pads rows to a power of two)
        rows = max(t[0].shape[0] for t in (self.points_a, self.points_b1, self.points_c))
        self.points_a, self.points_b1, self.points_c = (
            pad_table(*t, rows) for t in (self.points_a, self.points_b1, self.points_c)
        )
        # Coefficient table, SORTED by destination row once at load (host):
        # the per-proof reduction then runs as a sorted segment sum, and the
        # full keyless table (42.7M entries, ~2.7 GB of limbs) streams
        # through the device in _COEF_CHUNK slices.
        dest = pk.coef_m.astype(np.int64) * pk.domain_size + pk.coef_c
        nnz = dest.shape[0]
        order = np.argsort(dest, kind="stable")
        dest = dest[order].astype(np.int32)
        seg_max = int(np.diff(np.searchsorted(dest, np.arange(2 * pk.domain_size + 1))).max()) if nnz else 0
        assert seg_max < (1 << 23), "coefficient row too dense for 8-bit split sums"
        chunk = min(_COEF_CHUNK, max(nnz, 1))
        k = -(-nnz // chunk) or 1
        pad = k * chunk - nnz
        # pad with zero-value terms aimed at the last segment (keeps the
        # per-chunk ids sorted)
        s_sorted = np.pad(pk.coef_s[order].astype(np.int32), (0, pad))
        d_sorted = np.pad(dest, (0, pad), constant_values=2 * pk.domain_size - 1)
        v_sorted = np.pad(pk.coef_val[order], [(0, pad), (0, 0)])
        self.coef_s = dev(s_sorted.reshape(k, chunk))
        # per chunk: first covered dest row d_lo and the segment boundaries
        # of every row from there, padded to one width (jf.sorted_segment_
        # sum_mod rationale; see _eval_ab_fused)
        dk = d_sorted.reshape(k, chunk)
        d_los = dk[:, 0]
        width = int((dk[:, -1] - d_los).max()) + 1
        bounds = np.stack([
            np.searchsorted(row, np.arange(lo, lo + width + 1)) for row, lo in zip(dk, d_los)
        ]).astype(np.int32)
        self._coef_bounds, self._coef_d_los = dev(bounds), dev(d_los)
        # pre-scale Montgomery-stored coefs by R^2 (chunked): the reduction's
        # trailing REDC then lands values in the reference's raw-byte
        # representation.
        r2 = jf.consts(FR, FR.r2_mod_p)
        vals = dev(v_sorted.reshape(k, chunk, NUM_LIMBS))
        self.coef_val = jax.lax.map(lambda s: jf.mont_mul(s, r2, FR), vals)
        self.coset = self.plan.coset_powers()

    # ---- device phases -------------------------------------------------

    @staticmethod
    def _merge_scalars(scalars: jnp.ndarray, merge) -> jnp.ndarray:
        """Sum the scalars of duplicate table rows (see _dedup_point_table).

        Scalars are standard form; segment_sum_mod's REDC factor is
        cancelled by lifting to Montgomery form first:
        sum((w·R)) · R^-1 = sum(w) mod r.
        """
        if merge is None:
            return scalars
        order, bounds, _ = merge
        vals = jf.to_mont(jnp.take(scalars, order, axis=0), FR)
        return jf.sorted_segment_sum_mod(vals, bounds, FR)

    def _eval_ab(self, witness: jnp.ndarray) -> jnp.ndarray:
        """Coefficient-table evaluation: witness -> concatenated a|b vectors
        (2*domain, 16); one fused jit (see _eval_ab_fused)."""
        return _eval_ab_fused(
            witness, self.coef_s, self.coef_val, self._coef_bounds, self._coef_d_los,
            m2=2 * self.pk.domain_size,
        )

    def _h_scalars(self, witness: jnp.ndarray) -> jnp.ndarray:
        """Witness -> MSM_H scalar vector (the NTT phase), fully on device."""
        pk = self.pk
        ab = self._eval_ab(witness)
        a, b = ab[: pk.domain_size], ab[pk.domain_size :]
        c = jf.mont_mul(a, b, FR)

        # one batched (3, n, 16) iNTT -> coset shift -> NTT sweep instead of
        # the reference's three concurrent pipelines (groth16.cpp:169-262):
        # batching triples arithmetic intensity per kernel dispatch
        abc = jnp.stack([a, b, c])
        abc = self.plan.intt(abc)
        abc = jf.mont_mul(abc, self.coset, FR)  # shift: groth16.cpp:182-190
        abc = self.plan.ntt(abc)
        a, b, c = abc[0], abc[1], abc[2]
        h = jf.sub(jf.mont_mul(a, b, FR), c, FR)
        return jf.from_mont(h, FR)  # groth16.cpp:264-279

    # ---- full prove ------------------------------------------------------

    def prove(self, witness_limbs: np.ndarray, r: int | None = None, s: int | None = None) -> Proof:
        """witness_limbs: (nVars, 16) uint32 standard-form limb rows."""
        import os as _os
        import time as _time

        trace = _os.environ.get("KEYLESS_PROVE_TRACE") == "1"
        t_last = _time.monotonic()

        def _mark(name, out):
            # KEYLESS_PROVE_TRACE=1: sync after each stage and log its time
            nonlocal t_last
            if trace:
                jax.block_until_ready(out)
                now = _time.monotonic()
                print(f"prove.{name}: {(now - t_last) * 1e3:.1f} ms", flush=True)
                t_last = now
            return out

        pk = self.pk
        w = _mark("to_device", jnp.asarray(witness_limbs, jnp.uint32))
        assert w.shape == (pk.n_vars, NUM_LIMBS)

        def witness_msm(name, table, merge, curve):
            scalars = _mark(f"merge_{name}", self._merge_scalars(w, merge))
            return _mark(f"msm_{name}", msm(*table, scalars, curve=curve, c=_SPARSE_C))

        msm_a = witness_msm("a", self.points_a, self._merge_a, G1_CURVE)
        msm_b1 = witness_msm("b1", self.points_b1, self._merge_b1, G1_CURVE)
        msm_b2 = witness_msm("b2", self.points_b2, self._merge_b2, G2_CURVE)
        # the public rows of the padded C table are infinity, so the full
        # witness is a valid scalar vector here
        msm_c = witness_msm("c", self.points_c, self._merge_c, G1_CURVE)
        h = _mark("h_scalars", self._h_scalars(w))
        h = _mark("merge_h", self._merge_scalars(h, self._merge_h))
        msm_h = _mark("msm_h", msm(*self.points_h, h, curve=G1_CURVE))

        # decode the five MSM results to host affine points: the four G1
        # results in ONE batched call
        g1_batch = JacPoint(*(
            jnp.stack(coords)
            for coords in zip(msm_a, msm_b1, msm_c, msm_h)
        ))
        a_pt, b1_pt, c_pt, h_pt = G1_CURVE.decode_jacobian(g1_batch)
        b2_pt = G2_CURVE.decode_jacobian(JacPoint(*jax.tree.map(lambda v: v[None], msm_b2)))[0]
        _mark("decode", w)

        # host tail: blinding and final point assembly (groth16.cpp:288-353)
        r = _sample_fr() if r is None else r
        s = _sample_fr() if s is None else s
        g1, g2 = ref_curve.G1, ref_curve.G2

        pi_a = g1.add(g1.add(a_pt, pk.vk_alpha1), g1.mul(pk.vk_delta1, r))
        pi_b = g2.add(g2.add(b2_pt, pk.vk_beta2), g2.mul(pk.vk_delta2, s))
        pib1 = g1.add(g1.add(b1_pt, pk.vk_beta1), g1.mul(pk.vk_delta1, s))
        pi_c = g1.add(c_pt, h_pt)
        pi_c = g1.add(pi_c, g1.mul(pi_a, s))
        pi_c = g1.add(pi_c, g1.mul(pib1, r))
        pi_c = g1.add(pi_c, g1.neg(g1.mul(pk.vk_delta1, (r * s) % bn254.R_SCALAR)))
        return Proof(pi_a=pi_a, pi_b=pi_b, pi_c=pi_c)

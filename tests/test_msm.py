"""MSM kernels vs the host-int reference implementation."""

import numpy as np
import pytest

from keyless_zk_tpu.curves import ref_curve
from keyless_zk_tpu.curves.jacobian import G1_CURVE, G2_CURVE
from keyless_zk_tpu.fields import bn254
from keyless_zk_tpu.fields import jax_field as jf
from keyless_zk_tpu.fields.jax_field import FR
from keyless_zk_tpu.ops import msm as msm_mod
from keyless_zk_tpu.ops.msm import extract_digits, extract_digits_signed, msm


def _rand_scalars(rng, n):
    return [int(x) % bn254.R_SCALAR for x in rng.integers(1, 1 << 63, n) ** 2]


def _rand_points(rng, n, group=ref_curve.G1, gen=ref_curve.G1_GEN):
    return [group.mul(gen, int(k)) for k in rng.integers(1, 1 << 30, n)]


def test_extract_digits_roundtrip():
    rng = np.random.default_rng(3)
    vals = _rand_scalars(rng, 5)
    arr = jf.encode_ints(vals, FR)
    for c in (13, 16):
        digits = np.asarray(extract_digits(arr, c))
        for i, v in enumerate(vals):
            rec = sum(int(digits[w, i]) << (c * w) for w in range(digits.shape[0]))
            assert rec == v


@pytest.mark.slow
def test_msm_small_path():
    rng = np.random.default_rng(4)
    n = 7
    scalars = _rand_scalars(rng, n)
    pts = _rand_points(rng, n)
    pts[3] = None  # include an infinity
    px, py, pinf = G1_CURVE.encode_affine(pts)
    out = msm(px, py, pinf, jf.encode_ints(scalars, FR), curve=G1_CURVE)
    got = G1_CURVE.decode_jacobian(_as_batch(out))[0]
    assert got == ref_curve.G1.msm(scalars, pts)


@pytest.mark.slow
def test_msm_pippenger_path():
    rng = np.random.default_rng(5)
    n = 300
    scalars = _rand_scalars(rng, n)
    scalars[0] = 0  # zero scalar
    pts = _rand_points(rng, n)
    pts[1] = None
    px, py, pinf = G1_CURVE.encode_affine(pts)
    out = msm(
        px, py, pinf, jf.encode_ints(scalars, FR), curve=G1_CURVE,
        c=13, small_threshold=0,
    )
    got = G1_CURVE.decode_jacobian(_as_batch(out))[0]
    assert got == ref_curve.G1.msm(scalars, pts)


@pytest.mark.slow
def test_msm_g2_small():
    rng = np.random.default_rng(6)
    n = 4
    scalars = _rand_scalars(rng, n)
    pts = _rand_points(rng, n, ref_curve.G2, ref_curve.G2_GEN)
    px, py, pinf = G2_CURVE.encode_affine(pts)
    out = msm(px, py, pinf, jf.encode_ints(scalars, FR), curve=G2_CURVE)
    got = G2_CURVE.decode_jacobian(_as_batch(out))[0]
    assert got == ref_curve.G2.msm(scalars, pts)


def test_segment_sum_mod():
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    n, segs = 64, 10
    vals = _rand_scalars(rng, n)
    ids = np.sort(rng.integers(0, segs, n)).astype(np.int32)
    # pre-scale by R so the trailing REDC cancels (see segment_sum_mod doc)
    pre = jf.mont_mul(
        jf.encode_ints(vals, FR), jf.consts(FR, FR.r2_mod_p), FR
    )
    out = jf.segment_sum_mod(pre, jnp.asarray(ids), segs, FR)
    got = jf.decode_ints(out, FR)
    for k in range(segs):
        want = sum(v for v, i in zip(vals, ids) if i == k) % bn254.R_SCALAR
        assert got[k] == want


def _as_batch(pt):
    import jax

    return type(pt)(*jax.tree.map(lambda v: v[None], pt))


def _witness_mix(rng, n):
    """The witness MSMs' scalar mix: ~94% bit-valued, the rest uniform."""
    return [
        int.from_bytes(rng.bytes(32), "little") % bn254.R_SCALAR
        if rng.random() < 0.06 else int(rng.integers(0, 2))
        for _ in range(n)
    ]


@pytest.mark.parametrize(
    "group,gen,curve",
    [(ref_curve.G1, ref_curve.G1_GEN, G1_CURVE), (ref_curve.G2, ref_curve.G2_GEN, G2_CURVE)],
    ids=["g1", "g2"],
)
def test_msm_witness_mix_c12_with_duplicates(group, gen, curve, monkeypatch):
    """The proof's witness-MSM configuration (c=12, ~94% bit-valued
    scalars, duplicate points and an infinity) against host ints. Few scan
    steps per chunk so runs cross lane boundaries."""
    monkeypatch.setattr(msm_mod, "_SCAN_STEPS", 4)
    rng = np.random.default_rng(11)
    n = 160
    pts = _rand_points(rng, n // 2, group, gen)
    pts = pts + pts[: n - len(pts)]  # every point twice
    pts[7] = None
    scalars = _witness_mix(rng, n)
    scalars[3] = bn254.R_SCALAR - 1
    px, py, pinf = curve.encode_affine(pts)
    out = msm(px, py, pinf, jf.encode_ints(scalars, FR), curve=curve, c=12)
    assert curve.decode_jacobian(_as_batch(out))[0] == group.msm(scalars, pts)


def test_signed_digits_roundtrip():
    rng = np.random.default_rng(12)
    vals = _rand_scalars(rng, 6) + [0, 1, bn254.R_SCALAR - 1]
    for c in (5, 12, 13):
        keys, negs = (np.asarray(a) for a in extract_digits_signed(jf.encode_ints(vals, FR), c))
        assert keys.max() <= 1 << (c - 1)
        for i, v in enumerate(vals):
            rec = sum(
                (-1) ** int(negs[w, i]) * int(keys[w, i]) << (c * w)
                for w in range(keys.shape[0])
            )
            assert rec == v


def test_stream_shape_compacts_and_stays_dense_under_trace():
    import jax
    import jax.numpy as jnp

    n, c = 1024, 12
    sc = jnp.zeros((1, n, 16), jnp.uint32).at[0, :40, 0].set(1)  # 40 nonzero digits
    cap, chunk, lanes = msm_mod._stream_shape(G1_CURVE, sc, c)
    # compacted, at the 2n floor every sparse stream over n rows shares
    assert (cap, chunk) == (2 * n, 2 * n) and chunk % lanes == 0 and lanes >= 1
    rng = np.random.default_rng(13)
    busy = jf.encode_ints([int.from_bytes(rng.bytes(32), "little") for _ in range(n)], FR)
    assert msm_mod._stream_shape(G1_CURVE, busy[None], c)[0] == 1 << (22 * n - 1).bit_length()
    traced = jax.jit(lambda s: jnp.asarray(msm_mod._stream_shape(G1_CURVE, s, c)))
    cap_t, chunk_t, _ = (int(v) for v in traced(sc))
    dense = 1 << (22 * n - 1).bit_length()  # 22 windows of 12 bits
    assert cap_t == dense and chunk_t == min(dense, 1 << 23)

"""Point-table deduplication and chunked coefficient-evaluation tests.

Real zkeys repeat table points heavily (the full keyless setup's points_a
has 1,377,553 rows but only 1,194,986 distinct triples; points_b1/b2 only
796,854 — mostly wires absent from B), so the prover collapses them at
load and sums the duplicate rows' scalars per proof (groth16/prover.py
_dedup_point_table/_merge_scalars). These tests pin that algebra, the
chunked coefficient-table evaluation against host ints and across chunk
sizes (groth16.cpp:135-156 is the scatter being replaced), and prove()
end to end on a toy circuit.
"""

import json

import numpy as np
import pytest

from keyless_zk_tpu.curves import ref_curve
from keyless_zk_tpu.curves.jacobian import G1_CURVE
from keyless_zk_tpu.fields import bn254
from keyless_zk_tpu.fields.limbs import limbs_to_ints
from keyless_zk_tpu.groth16.prover import Groth16Prover, _dedup_point_table


def _random_table_with_dups(n, seed):
    """Affine G1 table where ~half the rows duplicate earlier rows and a few
    are infinity (the shape of real zkey tables)."""
    rng = np.random.default_rng(seed)
    base = [ref_curve.G1.mul(ref_curve.G1_GEN, int(k)) for k in rng.integers(1, 1 << 30, n)]
    x, y, inf = G1_CURVE.encode_affine(base)
    x, y, inf = map(np.array, (x, y, inf))  # writable host copies
    src = rng.integers(0, n, n)
    dup_mask = rng.random(n) < 0.5
    x[dup_mask] = x[src[dup_mask]]
    y[dup_mask] = y[src[dup_mask]]
    inf_mask = rng.random(n) < 0.1
    x[inf_mask] = 0
    y[inf_mask] = 0
    inf[inf_mask] = True
    return x, y, inf


def _host_msm(x, y, inf, scalars):
    xs = G1_CURVE.ops.decode(np.asarray(x))
    ys = G1_CURVE.ops.decode(np.asarray(y))
    pts = [None if i else (xx, yy) for xx, yy, i in zip(xs, ys, list(np.asarray(inf)))]
    return ref_curve.G1.msm([int(v) for v in limbs_to_ints(scalars)], pts)


def test_dedup_merge_msm_equivalence():
    """MSM(unique table, merged scalars) == MSM(raw table, raw scalars)."""
    import jax.numpy as jnp

    from keyless_zk_tpu.ops.msm import msm
    from keyless_zk_tpu.ops.testgen import random_scalars

    n = 192
    x, y, inf = _random_table_with_dups(n, seed=7)
    scalars = np.asarray(random_scalars(n, seed=8))

    (ux, uy, uinf), merge = _dedup_point_table(x, y, inf)
    assert merge is not None
    order, bounds, nu = merge
    assert nu < n
    # boundaries partition [0, n): each unique row owns one sorted run
    assert bounds[0] == 0 and bounds[-1] == n
    assert bounds.shape == (nu + 1,)
    assert (np.diff(bounds) > 0).all()

    merged = Groth16Prover._merge_scalars(
        jnp.asarray(scalars),
        (jnp.asarray(order), jnp.asarray(bounds), nu),
    )
    got = _host_msm(ux, uy, uinf, np.asarray(merged))
    want = _host_msm(x, y, inf, scalars)
    assert got == want


def test_merge_scalars_reduces_mod_r():
    """Scalar sums exceeding r must wrap (the merge feeds MSM digit
    extraction, which requires canonical scalars)."""
    import jax.numpy as jnp

    from keyless_zk_tpu.fields.limbs import int_to_limbs

    r = bn254.R_SCALAR
    vals = [r - 1, r - 2, 5]  # all map to segment 0: sum = 2r + 2 -> 2
    scalars = np.stack([np.asarray(int_to_limbs(v), np.uint32) for v in vals])
    merged = Groth16Prover._merge_scalars(
        jnp.asarray(scalars),
        (
            jnp.arange(3, dtype=np.int32),
            jnp.asarray([0, 3], np.int32),
            1,
        ),
    )
    assert int(limbs_to_ints(np.asarray(merged))[0]) == 2


TOY = "/root/reference/prover-service/resources/toy_circuit/"


@pytest.mark.skipif(
    not __import__("os").path.isdir(TOY), reason="reference toy artifacts unavailable"
)
def test_eval_ab_chunk_size_invariance(monkeypatch):
    """The streamed coefficient evaluation must not depend on _COEF_CHUNK
    (the full keyless table runs in 11 slices of 2^22; the toy runs in 1)."""
    import jax.numpy as jnp

    from keyless_zk_tpu.groth16 import load_wtns, load_zkey
    from keyless_zk_tpu.groth16 import prover as prover_mod

    pk = load_zkey(TOY + "toy_1.zkey")
    w = load_wtns(TOY + "toy.wtns")
    base = prover_mod.Groth16Prover(pk)._eval_ab(jnp.asarray(w.values))

    monkeypatch.setattr(prover_mod, "_COEF_CHUNK", 2)
    chunked = prover_mod.Groth16Prover(pk)._eval_ab(jnp.asarray(w.values))
    assert np.array_equal(np.asarray(base), np.asarray(chunked))


def test_prove_verifies_on_toy_circuit(toy_setup):
    """prove() end to end (merged witness MSMs, scanned coefficient
    evaluation, NTT sweep, decode, blinding) gives a proof the pairing
    check accepts."""
    from keyless_zk_tpu.groth16.pairing import verify_groth16

    cs, res = toy_setup
    rng = np.random.default_rng(9)
    inputs = {f"b{k}": int(rng.integers(0, 1 << 62)) for k in range(60)}
    w = cs.compute_witness(a=12345, **inputs)
    assert cs.check_witness(w) is None
    proof = Groth16Prover(res.pk).prove(cs.witness_np(w))
    assert verify_groth16(res.vk, [12345], proof.to_json_dict())


@pytest.mark.parametrize("chunk", [None, 7], ids=["one_chunk", "many_chunks"])
def test_eval_ab_matches_host_evaluation(chunk, monkeypatch, toy_setup):
    """The scanned coefficient evaluation equals A.w | B.w over host ints,
    with the table in one chunk and in many (rows spanning chunk edges)."""
    import jax.numpy as jnp

    from keyless_zk_tpu.fields import jax_field as jf
    from keyless_zk_tpu.fields.limbs import ints_to_limbs
    from keyless_zk_tpu.groth16 import prover as prover_mod

    pk = toy_setup[1].pk
    if chunk:
        monkeypatch.setattr(prover_mod, "_COEF_CHUNK", chunk)
    prover = prover_mod.Groth16Prover(pk)
    r = bn254.R_SCALAR
    rng = np.random.default_rng(5)
    w = [int.from_bytes(rng.bytes(32), "little") % r for _ in range(pk.n_vars)]
    got = jf.decode_ints(prover._eval_ab(jnp.asarray(ints_to_limbs(w))), jf.FR, mont=True)
    want = [0] * (2 * pk.domain_size)
    r_inv2 = pow(1 << 512, -1, r)  # zkey coefficients are stored times R^2
    for m, c, s, v in zip(pk.coef_m, pk.coef_c, pk.coef_s, limbs_to_ints(pk.coef_val)):
        want[int(m) * pk.domain_size + int(c)] += v * r_inv2 * w[int(s)]
    assert got == [x % r for x in want]


def _dup_pk_and_split_witness(pk, w, seed=3):
    """pk with every A/B1/B2/C row duplicated + witness split into two
    half-scalars per wire (sum_i w_i P_i unchanged). Returns (pk2, wit2)."""
    import dataclasses

    from keyless_zk_tpu.fields.limbs import int_to_limbs
    from keyless_zk_tpu.groth16.zkey import G1Table, G2Table

    def dup_g1(t):
        return G1Table(
            x=np.concatenate([t.x, t.x]),
            y=np.concatenate([t.y, t.y]),
            inf=np.concatenate([t.inf, t.inf]),
        )

    def dup_g2(t):
        return G2Table(
            x=np.concatenate([t.x, t.x]),
            y=np.concatenate([t.y, t.y]),
            inf=np.concatenate([t.inf, t.inf]),
        )

    n = pk.n_vars
    rng = np.random.default_rng(seed)
    w_ints = [int(v) for v in limbs_to_ints(w)]
    k = [int(x) for x in rng.integers(1, 1 << 61, n)]
    w_a = np.stack([np.asarray(int_to_limbs(x), np.uint32) for x in k])
    w_b = np.stack(
        [
            np.asarray(int_to_limbs((wi - ki) % bn254.R_SCALAR), np.uint32)
            for wi, ki in zip(w_ints, k)
        ]
    )
    wit2 = np.concatenate([w_a, w_b])
    pad_c = n - pk.points_c.x.shape[0]
    c_padded = G1Table(
        x=np.pad(pk.points_c.x, [(pad_c, 0), (0, 0)]),
        y=np.pad(pk.points_c.y, [(pad_c, 0), (0, 0)]),
        inf=np.pad(pk.points_c.inf, [(pad_c, 0)], constant_values=True),
    )
    pk2 = dataclasses.replace(
        pk,
        n_vars=2 * n,
        points_a=dup_g1(pk.points_a),
        points_b1=dup_g1(pk.points_b1),
        points_b2=dup_g2(pk.points_b2),
        points_c=dup_g1(c_padded),
    )
    return pk2, wit2


@pytest.mark.skipif(
    not __import__("os").path.isdir(TOY), reason="reference toy artifacts unavailable"
)
def test_batch_prove_with_duplicated_table_rows():
    """prove_batch on a pk whose tables contain duplicate rows must merge
    each witness's duplicate-row scalars before the MSMs (the round-4 code
    fed raw n_vars scalars to msm over n_unique-row tables; JAX clips the
    out-of-range gathers, yielding silently wrong proofs)."""
    import jax.numpy as jnp

    from keyless_zk_tpu.groth16 import load_wtns, load_zkey, verify_groth16
    from keyless_zk_tpu.parallel.batch_prover import BatchProver

    pk, w = load_zkey(TOY + "toy_1.zkey"), load_wtns(TOY + "toy.wtns")
    pk2, wit2 = _dup_pk_and_split_witness(pk, w.values)

    prover = Groth16Prover(pk2)
    assert prover._merge_a is not None  # the dup path must actually engage
    orig_eval = prover._eval_ab
    # coef table reads witness[s]; the duplicated layout splits wire values
    # across two rows the coef evaluation cannot see — evaluate with the
    # true witness instead (same patch as the single-prove test above).
    prover._eval_ab = lambda _: orig_eval(jnp.asarray(w.values))

    batch = BatchProver(prover, max_batch=2)
    try:
        proofs = batch.prove_batch([wit2, wit2])
    finally:
        batch.shutdown()
    vk = json.load(open(TOY + "toy_vk.json"))
    pub = limbs_to_ints(w.values[1 : 1 + pk.n_public])
    for proof in proofs:
        assert verify_groth16(vk, pub, proof.to_json_dict())


@pytest.mark.skipif(
    not __import__("os").path.isdir(TOY), reason="reference toy artifacts unavailable"
)
def test_toy_prove_with_duplicated_table_rows():
    """End-to-end: a pk whose A/B tables contain duplicate rows (wire split
    into two half-scalars) must still produce a verifying proof."""
    import dataclasses

    from keyless_zk_tpu.groth16 import load_wtns, load_zkey, verify_groth16
    from keyless_zk_tpu.groth16.zkey import G1Table, G2Table

    pk, w = load_zkey(TOY + "toy_1.zkey"), load_wtns(TOY + "toy.wtns")

    # duplicate every A/B1/B2 row; split each witness scalar into k + (w-k)
    # across the two copies: sum_i w_i P_i is unchanged.
    def dup_g1(t):
        return G1Table(
            x=np.concatenate([t.x, t.x]),
            y=np.concatenate([t.y, t.y]),
            inf=np.concatenate([t.inf, t.inf]),
        )

    def dup_g2(t):
        return G2Table(
            x=np.concatenate([t.x, t.x]),
            y=np.concatenate([t.y, t.y]),
            inf=np.concatenate([t.inf, t.inf]),
        )

    n = pk.n_vars
    rng = np.random.default_rng(3)
    from keyless_zk_tpu.fields.limbs import int_to_limbs

    w_ints = [int(v) for v in limbs_to_ints(w.values)]
    k = [int(x) for x in rng.integers(1, 1 << 61, n)]
    w_a = np.stack([np.asarray(int_to_limbs(x), np.uint32) for x in k])
    w_b = np.stack(
        [
            np.asarray(int_to_limbs((wi - ki) % bn254.R_SCALAR), np.uint32)
            for wi, ki in zip(w_ints, k)
        ]
    )
    wit2 = np.concatenate([w_a, w_b])

    # pre-pad C to n rows (the pairing the prover would otherwise create
    # with its own front pad), THEN duplicate, so each copy's row i pairs
    # with its half-scalar and the halves sum back to w_i * C_i.
    pad_c = n - pk.points_c.x.shape[0]
    c_padded = G1Table(
        x=np.pad(pk.points_c.x, [(pad_c, 0), (0, 0)]),
        y=np.pad(pk.points_c.y, [(pad_c, 0), (0, 0)]),
        inf=np.pad(pk.points_c.inf, [(pad_c, 0)], constant_values=True),
    )
    pk2 = dataclasses.replace(
        pk,
        n_vars=2 * n,
        points_a=dup_g1(pk.points_a),
        points_b1=dup_g1(pk.points_b1),
        points_b2=dup_g2(pk.points_b2),
        points_c=dup_g1(c_padded),
    )
    # coef table reads witness[s]; with the duplicated layout, wire i's
    # value is w_a[i] + w_b[i], which the coef evaluation cannot see — so
    # patch the evaluation witness separately via a prover subclass.
    prover = Groth16Prover(pk2)
    orig_eval = prover._eval_ab

    import jax.numpy as jnp

    def eval_with_true_witness(_):
        return orig_eval(jnp.asarray(w.values))

    prover._eval_ab = eval_with_true_witness
    proof = prover.prove(wit2, r=111, s=222)
    vk = json.load(open(TOY + "toy_vk.json"))
    pub = limbs_to_ints(w.values[1 : 1 + pk.n_public])
    assert verify_groth16(vk, pub, proof.to_json_dict())

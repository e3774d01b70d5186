"""Groth16 proving with every device phase sharded over a mesh.

The single-chip prover (groth16/prover.py) runs 5 MSMs + the coset-NTT
polynomial phase on one device. This module shards that whole compute over
a `jax.sharding.Mesh`:

- the five MSMs partition their points/scalars across the mesh
  (parallel/sharded.sharded_msm: per-chip Pippenger + one all_gather of
  Jacobian partials),
- the three polynomial transforms run as four-step NTTs (one all-to-all
  each, parallel/sharded.four_step_ntt),
- the coefficient scatter and pointwise field ops stay data-local.

This is the answer to BASELINE configs[4]'s N>=2 scaling row: a single
proof's critical path spread over chips (intra-proof parallelism), with
batch-level parallelism (batch_prover.py) composable on top. Exercised on
the virtual CPU mesh by dryrun_multichip and tests/test_parallel.py.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ..curves import ref_curve
from ..curves.jacobian import G1_CURVE, G2_CURVE, JacPoint
from ..fields import bn254
from ..fields import jax_field as jf
from ..fields.jax_field import FR
from ..fields.limbs import NUM_LIMBS
from ..groth16.prover import Groth16Prover, Proof, _sample_fr
from .sharded import four_step_ntt, sharded_msm


class ShardedGroth16Prover(Groth16Prover):
    """Groth16Prover whose device phases shard across `mesh`.

    Point tables must be padded so the mesh size divides every MSM length;
    `_pad_tables` appends infinity rows (scalar pairing unchanged: the
    witness vector is padded with zeros).
    """

    def __init__(self, pk, mesh: Mesh, axis: str = "data", **kw):
        super().__init__(pk, **kw)
        self.mesh = mesh
        self.axis = axis
        self.n_dev = mesh.shape[axis]
        if self.domain_pow < 2 * (self.n_dev - 1).bit_length():
            raise ValueError("domain too small to four-step over this mesh")
        self._pad_tables()

    def _pad_tables(self) -> None:
        d = self.n_dev

        def pad_to(table, n):
            x, y, inf = table
            pad = -len(inf) % n
            if pad == 0:
                return table, 0
            return (
                jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1)),
                jnp.pad(y, [(0, pad)] + [(0, 0)] * (y.ndim - 1)),
                jnp.pad(inf, [(0, pad)], constant_values=True),
            ), pad

        self.points_a, self._pad_vars = pad_to(self.points_a, d)
        self.points_b1, _ = pad_to(self.points_b1, d)
        self.points_b2, _ = pad_to(self.points_b2, d)
        self.points_c, _ = pad_to(self.points_c, d)
        self.points_h, self._pad_h = pad_to(self.points_h, d)

    def _msm(self, table, scalars, curve):
        pad = table[0].shape[0] - scalars.shape[0]
        if pad:
            scalars = jnp.pad(scalars, [(0, pad), (0, 0)])
        return sharded_msm(*table, scalars, curve=curve, mesh=self.mesh, axis=self.axis)

    def _h_scalars(self, witness: jnp.ndarray) -> jnp.ndarray:
        pk = self.pk
        ab = self._eval_ab(witness)  # chunked sorted-segment evaluation
        a, b = ab[: pk.domain_size], ab[pk.domain_size :]
        c = jf.mont_mul(a, b, FR)

        def coset_transform(x):
            x = four_step_ntt(x, domain_pow=self.domain_pow, mesh=self.mesh,
                              axis=self.axis, inverse=True)
            x = jf.mont_mul(x, self.coset, FR)
            return four_step_ntt(x, domain_pow=self.domain_pow, mesh=self.mesh,
                                 axis=self.axis)

        a, b, c = coset_transform(a), coset_transform(b), coset_transform(c)
        h = jf.sub(jf.mont_mul(a, b, FR), c, FR)
        return jf.from_mont(h, FR)

    def prove(self, witness_limbs: np.ndarray, r: int | None = None, s: int | None = None) -> Proof:
        pk = self.pk
        w = jnp.asarray(witness_limbs)
        assert w.shape == (pk.n_vars, NUM_LIMBS)

        msm_a = self._msm(self.points_a, self._merge_scalars(w, self._merge_a), G1_CURVE)
        msm_b1 = self._msm(self.points_b1, self._merge_scalars(w, self._merge_b1), G1_CURVE)
        msm_b2 = self._msm(self.points_b2, self._merge_scalars(w, self._merge_b2), G2_CURVE)
        msm_c = self._msm(self.points_c, self._merge_scalars(w, self._merge_c), G1_CURVE)
        h = self._h_scalars(w)
        msm_h = self._msm(self.points_h, self._merge_scalars(h, self._merge_h), G1_CURVE)

        def dec(curve, p):
            return curve.decode_jacobian(JacPoint(*jax.tree.map(lambda v: v[None], p)))[0]

        a_pt, b1_pt, c_pt, h_pt = (dec(G1_CURVE, p) for p in (msm_a, msm_b1, msm_c, msm_h))
        b2_pt = dec(G2_CURVE, msm_b2)

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

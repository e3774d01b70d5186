"""Batched proving: many proofs per device sweep.

The reference serializes proving behind a global mutex — one proof at a
time per process (prover-service/src/request_handler/prover_state.rs:21,
prover_handler.rs:266-268).  This module is the batched replacement:
requests queue up and are proven as a *batch*, with every kernel of the
Groth16 pipeline batched over the request dimension (vmapped MSMs and
NTTs), and the batch dimension shardable across a device mesh for
multi-chip scaling (one or more proofs per chip, DCN/ICI only at dispatch).

Throughput model: a single proof underutilizes a chip between kernel
launches; batching B proofs multiplies arithmetic intensity at the same
table footprint (point tables are shared across the batch — the scalars
differ per request).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..fields import jax_field as jf
from ..fields.jax_field import FR
from ..groth16.prover import Groth16Prover, Proof, _sample_fr


@dataclass
class _Pending:
    witness_limbs: np.ndarray
    event: threading.Event
    result: object = None
    error: Exception | None = None


class BatchProver:
    """Queue + batch executor around a Groth16Prover.

    prove() blocks the calling thread until its proof is ready; requests
    arriving while a batch is in flight coalesce into the next batch
    (max_batch bounds device memory).
    """

    def __init__(self, prover: Groth16Prover, max_batch: int = 8):
        self.prover = prover
        self.max_batch = max_batch
        self._queue: queue.Queue[_Pending] = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._stop = False
        self._worker.start()

    def prove(self, witness_limbs: np.ndarray, timeout: float | None = None) -> Proof:
        item = _Pending(witness_limbs=witness_limbs, event=threading.Event())
        self._queue.put(item)
        if not item.event.wait(timeout):
            raise TimeoutError("batched prove timed out")
        if item.error is not None:
            raise item.error
        return item.result

    def shutdown(self) -> None:
        self._stop = True
        self._queue.put(None)  # wake the worker

    # ---- worker ----------------------------------------------------------

    def _drain_batch(self) -> list[_Pending]:
        first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        while len(batch) < self.max_batch:
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _run(self) -> None:
        while not self._stop:
            batch = self._drain_batch()
            if not batch:
                continue
            try:
                # pad to the fixed batch size so one compiled kernel shape
                # serves every queue state (ragged batches would recompile)
                wits = [b.witness_limbs for b in batch]
                while len(wits) < self.max_batch:
                    wits.append(wits[0])
                proofs = self.prove_batch(wits)
                for item, proof in zip(batch, proofs):
                    item.result = proof
            except Exception as e:  # noqa: BLE001 — propagate to every waiter
                for item in batch:
                    item.error = e
            finally:
                for item in batch:
                    item.event.set()

    # ---- batched pipeline ---------------------------------------------------

    def prove_batch(self, witnesses: list[np.ndarray]) -> list[Proof]:
        """Prove B witnesses in one device sweep.

        The five MSMs and the h-polynomial NTT pipeline run under vmap over
        the batch dimension; the tiny blinding tail stays host-side per
        proof (groth16.cpp:288-353).
        """
        from ..curves.jacobian import G1_CURVE, G2_CURVE, JacPoint
        from ..curves import ref_curve
        from ..fields import bn254
        from ..ops.msm import msm_batch

        pk = self.prover.pk
        B = len(witnesses)
        w = jnp.asarray(np.stack(witnesses))  # (B, nVars, 16)

        def one_msm(table, merge, curve, scalars=None, c=None):
            # merge duplicate-row scalars per witness (the deduped tables
            # hold n_unique rows; feeding raw n_vars scalars would silently
            # clip the out-of-range gathers — groth16/prover.py:70-105),
            # then ONE batched flat-stream MSM over the shared table
            src = w if scalars is None else scalars
            merged = jnp.stack(
                [Groth16Prover._merge_scalars(src[i], merge) for i in range(B)]
            )
            pt = msm_batch(*table, merged, curve=curve, c=c)
            return pt.x, pt.y, pt.z

        from ..groth16.prover import _SPARSE_C

        p = self.prover
        msm_a = one_msm(p.points_a, p._merge_a, G1_CURVE, c=_SPARSE_C)
        msm_b1 = one_msm(p.points_b1, p._merge_b1, G1_CURVE, c=_SPARSE_C)
        msm_b2 = one_msm(p.points_b2, p._merge_b2, G2_CURVE, c=_SPARSE_C)
        msm_c = one_msm(p.points_c, p._merge_c, G1_CURVE, c=_SPARSE_C)
        # the h pipeline reuses the single-prover compiled graphs per
        # element (async dispatch overlaps them); vmap would force separate
        # batched compiles of the NTT kernels for every batch size
        h = jnp.stack([p._h_scalars(w[i]) for i in range(B)])
        msm_h = one_msm(p.points_h, p._merge_h, G1_CURVE, scalars=h)

        proofs = []
        g1, g2 = ref_curve.G1, ref_curve.G2
        a_pts = G1_CURVE.decode_jacobian(JacPoint(*msm_a))
        b1_pts = G1_CURVE.decode_jacobian(JacPoint(*msm_b1))
        b2_pts = G2_CURVE.decode_jacobian(JacPoint(*msm_b2))
        c_pts = G1_CURVE.decode_jacobian(JacPoint(*msm_c))
        h_pts = G1_CURVE.decode_jacobian(JacPoint(*msm_h))
        for i in range(B):
            r, s = _sample_fr(), _sample_fr()
            pi_a = g1.add(g1.add(a_pts[i], pk.vk_alpha1), g1.mul(pk.vk_delta1, r))
            pi_b = g2.add(g2.add(b2_pts[i], pk.vk_beta2), g2.mul(pk.vk_delta2, s))
            pib1 = g1.add(g1.add(b1_pts[i], pk.vk_beta1), g1.mul(pk.vk_delta1, s))
            pi_c = g1.add(c_pts[i], h_pts[i])
            pi_c = g1.add(pi_c, g1.mul(pi_a, s))
            pi_c = g1.add(pi_c, g1.mul(pib1, r))
            pi_c = g1.add(pi_c, g1.neg(g1.mul(pk.vk_delta1, (r * s) % bn254.R_SCALAR)))
            proofs.append(Proof(pi_a=pi_a, pi_b=pi_b, pi_c=pi_c))
        return proofs

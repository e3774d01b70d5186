"""Proofs/sec at batch sizes 1/4/8 through the BatchProver (BASELINE
configs[4]: batched prover-service load, proofs/sec/chip).

Runs on whatever backend is active (the GPU when present; the CPU backend
with JAX_PLATFORMS=cpu).

    python scripts/bench_batch.py [--iters 32] [--toy | --config small]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))

from keyless_zk_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

TOY = "/root/reference/prover-service/resources/toy_circuit/"


def run_batch_bench(config: str = "toy", iters: int = 32, batches=(1, 4, 8)) -> dict:
    """Proofs/sec through the BatchProver; returns the best batch point.

    {"proofs_per_sec": best, "batch": best_bsz, "results": [per-batch dicts]}.
    The reference cannot batch at all — its FullProver sits behind a global
    mutex (prover-service prover_state.rs:21), so any >1 batch win here is
    structural."""
    from keyless_zk_tpu.fields.limbs import ints_to_limbs, limbs_to_ints
    from keyless_zk_tpu.groth16 import Groth16Prover, load_wtns, load_zkey
    from keyless_zk_tpu.parallel.batch_prover import BatchProver

    if config == "toy":
        pk = load_zkey(TOY + "toy_1.zkey")
        base = limbs_to_ints(load_wtns(TOY + "toy.wtns").values)

        def witness(i):
            vals = list(base)
            a, b = [(2, 3), (3, 2), (1, 6), (6, 1)][i % 4]
            vals[1], vals[2] = a, b
            return ints_to_limbs(vals)

    else:
        from keyless_zk_tpu.service.prover_state import ProverServiceState
        from test_keyless_circuit import SMALL
        from keyless_zk_tpu.circuits.keyless_circuit import KeylessConfig

        cfg = SMALL if config == "small" else KeylessConfig()
        state = ProverServiceState.new_for_testing(keyless_config=cfg)
        state.init_prover_from_native_setup(persist=True)
        pk = state.prover.pk

        from jwt_fixture import make_test_jwt
        from keyless_zk_tpu.input_processing.input_signals import derive_circuit_input_signals
        from keyless_zk_tpu.circuits.keyless_circuit import witness_kwargs

        tj = make_test_jwt()
        signals, _pih = derive_circuit_input_signals(
            state.circuit_config, tj.vi, state.config.max_committed_epk_bytes
        )
        kw = witness_kwargs(signals)
        if state.witness_prog is not None:
            w64 = state.witness_prog.compute_witness(**kw)
            w_np = state.witness_prog.witness_limbs(w64)
        else:
            w = state.cs.compute_witness(**kw)
            w_np = state.cs.witness_np(w)

        def witness(i):
            return w_np

    prover = Groth16Prover(pk)
    results = []
    for bsz in batches:
        batch = BatchProver(prover, max_batch=bsz)
        try:
            # warm compile for this batch shape
            batch.prove_batch([witness(i) for i in range(bsz)])
            t0 = time.perf_counter()
            done = 0
            while done < iters:
                take = min(bsz, iters - done)
                batch.prove_batch([witness(done + i) for i in range(take)])
                done += take
            dt = time.perf_counter() - t0
            results.append(
                {"batch": bsz, "proofs_per_sec": round(iters / dt, 3),
                 "ms_per_proof": round(dt / iters * 1e3, 1)}
            )
            print(json.dumps(results[-1]), flush=True)
        finally:
            batch.shutdown()
    best = max(results, key=lambda r: r["proofs_per_sec"])
    return {
        "proofs_per_sec": best["proofs_per_sec"],
        "batch": best["batch"],
        "results": results,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--config", default="toy", choices=["toy", "small", "full"])
    args = ap.parse_args()
    res = run_batch_bench(config=args.config, iters=args.iters)
    print(json.dumps({"metric": f"batch_throughput_{args.config}", **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

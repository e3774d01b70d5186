"""Time the host-side phases of a full-config prove (no accelerator needed).

The flagship latency budget (groth16.cpp:41-360 is the device part) also
pays host phases per request: signal derivation (input_signals.rs:18-96),
witness generation (prover_handler.rs:541-572 — the reference forks a
compiled main_c), and the constraint re-check. This probe builds the FULL
KeylessConfig circuit and times each.

    JAX_PLATFORMS=cpu python scripts/probe_full_host_phases.py
"""

from __future__ import annotations

import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))


def main():
    t = {}

    def mark(name, t0):
        t[name] = round(time.monotonic() - t0, 3)
        print(f"{name}: {t[name]}s", file=sys.stderr, flush=True)

    from keyless_zk_tpu.circuits.keyless_circuit import (
        KeylessConfig,
        build_keyless_circuit,
        to_circuit_config,
    )

    cfg = KeylessConfig()
    t0 = time.monotonic()
    cs = build_keyless_circuit(cfg)
    mark("build_circuit", t0)
    print(
        f"n_wires={cs.n_wires} n_constraints={len(cs.constraints)}",
        file=sys.stderr,
        flush=True,
    )

    t0 = time.monotonic()
    from keyless_zk_tpu.circuits.witness_engine import CompiledWitnessProgram

    prog = CompiledWitnessProgram(cs)
    mark("compile_witness_program", t0)

    from jwt_fixture import make_test_jwt
    from keyless_zk_tpu.input_processing.input_signals import (
        derive_circuit_input_signals,
    )
    tj = make_test_jwt()
    t0 = time.monotonic()
    signals, pih = derive_circuit_input_signals(
        to_circuit_config(cfg), tj.vi, max_committed_epk_bytes=93
    )
    mark("derive_circuit_input_signals", t0)

    from keyless_zk_tpu.circuits.keyless_circuit import witness_kwargs

    kw = witness_kwargs(signals)
    t0 = time.monotonic()
    w64 = prog.compute_witness(**kw)
    mark("generate_witness_cold", t0)
    t0 = time.monotonic()
    w64 = prog.compute_witness(**kw)
    mark("generate_witness_warm", t0)

    t0 = time.monotonic()
    bad = prog.check_witness(w64)
    mark("check_witness", t0)
    assert bad is None, f"constraint {bad} violated"

    t0 = time.monotonic()
    limbs = prog.witness_limbs(w64)
    mark("witness_limbs", t0)
    print(f"witness wires: {limbs.shape}", file=sys.stderr, flush=True)

    print(json.dumps({"status": "ok", "phases_s": t, "n_wires": cs.n_wires,
                      "n_constraints": len(cs.constraints)}))


if __name__ == "__main__":
    main()

"""Drive the full service prove pipeline on the active JAX backend.

Runs outside pytest, so the GPU is used when present (tests force CPU).
Procures a native setup for the keyless config, then serves prove requests
end-to-end and reports per-phase timings (the 9-phase breakdown the
reference exports as Prometheus histograms, metrics.rs:31-39).

    python scripts/full_prove.py [--config small|full] [--repeat N]
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


def run_full_prove(config: str = "small", repeat: int = 2) -> dict:
    """Procure/load the native setup, serve prove requests, return timings.

    Returns {"status", "prove_ms" (warm), "cold_ms", "phases" {name: ms},
    "n_vars", "domain_size"}.
    """
    from keyless_zk_tpu.circuits.keyless_circuit import KeylessConfig
    from keyless_zk_tpu.service.handler import handle_request
    from keyless_zk_tpu.service.jwk import RsaJwk
    from keyless_zk_tpu.service.metrics import PROVE_BREAKDOWN_SECONDS
    from keyless_zk_tpu.service.prover_state import ProverServiceState

    if config == "small":
        from test_keyless_circuit import SMALL as cfg
    else:
        cfg = KeylessConfig()

    from jwt_fixture import (
        EPK_BLINDER,
        EPK_BYTES,
        EXP_DATE,
        EXP_HORIZON,
        PEPPER,
        make_test_jwt,
    )

    t0 = time.monotonic()
    state = ProverServiceState.new_for_testing(keyless_config=cfg)
    state.init_prover_from_native_setup(persist=True)  # content-addressed cache
    t1 = time.monotonic()
    print(
        f"setup: {t1 - t0:.1f}s "
        f"(n_vars={state.prover.pk.n_vars}, domain={state.prover.pk.domain_size})",
        file=sys.stderr,
    )

    tj = make_test_jwt()
    state.jwk_cache.insert(
        tj.vi.jwt.payload.iss,
        RsaJwk(kid="test-kid-01", n=tj.rsa_key.public_key().public_numbers().n),
    )
    body = json.dumps(
        {
            "jwt_b64": tj.jwt_str,
            "epk": EPK_BYTES.hex(),
            "epk_blinder": EPK_BLINDER.to_bytes(31, "little").hex(),
            "exp_date_secs": EXP_DATE,
            "exp_horizon_secs": EXP_HORIZON,
            "pepper": PEPPER.to_bytes(31, "little").hex(),
            "uid_key": "sub",
        }
    ).encode()

    times = []
    phases = {}
    for i in range(max(repeat, 1)):
        before = PROVE_BREAKDOWN_SECONDS.sums()
        t2 = time.monotonic()
        code, _, payload = handle_request(state, "POST", "/v0/prove", body)
        t3 = time.monotonic()
        assert code == 200, payload
        times.append(t3 - t2)
        after = PROVE_BREAKDOWN_SECONDS.sums()
        phases = {
            k[0]: round((v - before.get(k, 0.0)) * 1e3, 1) for k, v in after.items()
        }
        print(f"prove request {i}: {t3 - t2:.1f}s  OK  {phases}", file=sys.stderr)

    zkey_path = os.path.join(
        state.config.resources_dir, "default", "prover_key.zkey"
    )
    return {
        "status": "ok",
        "config": config,
        "cold_ms": round(times[0] * 1e3, 1),
        "prove_ms": round(min(times[1:] or times) * 1e3, 1),
        "phases": phases,
        "n_vars": state.prover.pk.n_vars,
        "domain_size": state.prover.pk.domain_size,
        # full-scale snarkjs-format zkey interop evidence: warm service
        # start parses this zkey through groth16/zkey.py (the same loader
        # the circom interop tests drive), cf. fullprover.cpp:140-174.
        "setup_ms": round((t1 - t0) * 1e3, 1),
        "zkey_bytes": (
            os.path.getsize(zkey_path) if os.path.exists(zkey_path) else None
        ),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="small", choices=["small", "full"])
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args()
    res = run_full_prove(config=args.config, repeat=args.repeat)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

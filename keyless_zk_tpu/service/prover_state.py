"""Shared prover service state + the prove pipeline.

Mirror of prover-service/src/request_handler/prover_state.rs (state init)
and prover_handler.rs (the prove pipeline with its 9 instrumented phases).
Differences from the reference are deliberate redesigns:

- witness generation is in-process (native ConstraintSystem hints), not a
  forked circom binary (prover_handler.rs:516-527);
- the prover is the device-resident Groth16 engine; requests queue through
  a lock the same way the reference's `Mutex<Option<FullProver>>` does
  (prover_state.rs:21) — batched/multi-chip proving lifts this limit via
  keyless_zk_tpu.parallel.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field

from ..circuits.keyless_circuit import (
    KeylessConfig,
    build_keyless_circuit,
    to_circuit_config,
    witness_kwargs,
)
from ..groth16.prover import Groth16Prover
from ..input_processing.input_signals import derive_circuit_input_signals
from .config import ProverServiceConfig
from .jwk import JwkCache, JwkFetcher
from .metrics import PROVE_BREAKDOWN_SECONDS, PROOFS_TOTAL
from .training_wheels import (
    TrainingWheelsKeyPair,
    preprocess_and_validate_request,
    proof_and_statement_bytes,
)
from .types import BadRequest, InternalError, RequestInput, success_response


@dataclass
class ProverServiceState:
    config: ProverServiceConfig
    circuit_config: object
    keyless_config: KeylessConfig | None
    tw_keypair: TrainingWheelsKeyPair
    jwk_cache: JwkCache
    jwk_fetcher: JwkFetcher | None = None
    # proving backend (None for endpoint-only testing,
    # prover_state.rs:53-78 `new_for_testing`)
    cs: object | None = None
    witness_prog: object | None = None  # native engine (circuits/witness_engine.py)
    prover: Groth16Prover | None = None
    batch_prover: object | None = None  # BatchProver when config.batch_proving
    vk: dict | None = None
    prove_lock: threading.Lock = field(default_factory=threading.Lock)
    deployment_info: dict = field(default_factory=dict)
    # wall seconds of each start-up step (circuit_build, setup_procurement,
    # prover_load), filled by init_prover_from_native_setup
    startup_seconds: dict = field(default_factory=dict)

    @classmethod
    def new_for_testing(
        cls,
        keyless_config: KeylessConfig | None = None,
        tw_sk_hex: str = "11" * 32,
        with_prover: bool = False,
        jwk_fetch=None,
    ) -> "ProverServiceState":
        cfg = ProverServiceConfig()
        kc = keyless_config or KeylessConfig()
        state = cls(
            config=cfg,
            circuit_config=to_circuit_config(kc),
            keyless_config=kc,
            tw_keypair=TrainingWheelsKeyPair.from_sk_hex(tw_sk_hex),
            jwk_cache=JwkCache(),
        )
        if jwk_fetch is not None:
            state.jwk_fetcher = JwkFetcher(state.jwk_cache, fetch=jwk_fetch)
        if with_prover:
            state.init_prover_from_native_setup()
        return state

    def init_prover_from_native_setup(self, rng=None, persist: bool = False) -> None:
        """Build the keyless circuit and run the native 1-party setup
        (replaces zkey procurement, scripts/python/setups/testing_setup.py).

        With persist=True the setup goes through the content-addressed
        store (tooling/setup_tool.py) and is reloaded from its zkey on
        later startups. Warm persistent starts also reload the compiled
        witness program (the analog of circom's prebuilt main_c,
        testing_setup.py:72-79) and skip circuit construction entirely
        (~2 min at the full config); debug-check mode still builds the
        circuit, since the R1CS re-check needs the constraints."""
        from ..circuits.r1cs_file import r1cs_from_cs
        from ..circuits.setup import groth16_setup

        t0 = time.monotonic()

        def step(name):
            nonlocal t0
            now = time.monotonic()
            self.startup_seconds[name] = now - t0
            t0 = now

        if persist:
            import json
            import os

            from ..circuits.witness_engine import CompiledWitnessProgram
            from ..groth16.zkey import load_zkey
            from ..tooling.setup_tool import circuit_checksum, procure

            root = self.config.resources_dir
            setup_dir = os.path.join(root, circuit_checksum(self.keyless_config))
            prog_path = os.path.join(setup_dir, "witness_program.npz")
            warm = (
                os.path.exists(os.path.join(setup_dir, ".complete"))
                and os.path.exists(prog_path)
                and not self.config.enable_debug_checks
            )
            if warm:
                self.cs = None
                self.witness_prog = CompiledWitnessProgram.load(prog_path)
                step("circuit_build")
                procure(self.keyless_config, root=root)  # refresh default slot
            else:
                self.cs = build_keyless_circuit(self.keyless_config)
                try:
                    self.witness_prog = CompiledWitnessProgram(self.cs)
                except Exception:
                    self.witness_prog = None  # no C toolchain: Python path
                step("circuit_build")
                setup_dir = procure(self.keyless_config, root=root, cs=self.cs)
                if self.witness_prog is not None:
                    try:
                        self.witness_prog.save(prog_path)
                    except Exception:
                        pass  # unserializable ops: rebuild next start
            step("setup_procurement")
            pk = load_zkey(os.path.join(setup_dir, "prover_key.zkey"))
            with open(os.path.join(setup_dir, "verification_key.json")) as f:
                self.vk = json.load(f)
            self.prover = Groth16Prover(pk)
        else:
            self.cs = build_keyless_circuit(self.keyless_config)
            try:
                from ..circuits.witness_engine import CompiledWitnessProgram

                self.witness_prog = CompiledWitnessProgram(self.cs)
            except Exception:
                self.witness_prog = None  # no C toolchain: Python witness path
            step("circuit_build")
            res = groth16_setup(r1cs_from_cs(self.cs), rng=rng)
            step("setup_procurement")
            self.prover = Groth16Prover(res.pk)
            self.vk = res.vk
        step("prover_load")
        if self.config.batch_proving:
            from ..parallel.batch_prover import BatchProver

            self.batch_prover = BatchProver(self.prover, max_batch=self.config.max_batch)
        self.check_pairing_backend()

    def check_pairing_backend(self) -> str:
        """Probe which pairing implementation verify_proof will use and make
        degradation loud: a gcc-less box silently falls back to the ~1.4 s
        pure-Python verifier (groth16/pairing.py docstring) — log it, count
        it, and (with config.require_native_pairing) fail the healthcheck.
        """
        from ..groth16 import pairing_native
        from ..utils.logging import log_event
        from .metrics import PAIRING_BACKEND

        backend = "native" if pairing_native.available() else "python_fallback"
        self.pairing_backend = backend
        PAIRING_BACKEND.inc(backend=backend)
        if backend != "native":
            log_event(
                "native pairing library unavailable; Groth16 verification "
                "falls back to the pure-Python tower (~100x slower)",
                level="WARN",
                backend=backend,
            )
        return backend

    def healthy(self) -> tuple[bool, str]:
        """Liveness verdict for /healthcheck (handler.rs:107-111), extended
        with the native-pairing production guard."""
        backend = getattr(self, "pairing_backend", None)
        if self.config.require_native_pairing and backend != "native":
            return False, f"native pairing required but backend is {backend}"
        return True, "ok"

    # ---- the prove pipeline (prover_handler.rs:48-152) --------------------

    def handle_prove(self, body: bytes) -> dict:
        if self.prover is None or (self.cs is None and self.witness_prog is None):
            raise InternalError("prover not initialized")

        phases = {}

        def phase(name):
            class _T:
                def __enter__(s):
                    s.t0 = time.monotonic()

                def __exit__(s, *a):
                    dt = time.monotonic() - s.t0
                    phases[name] = dt
                    PROVE_BREAKDOWN_SECONDS.observe(dt, phase=name)

            return _T()

        with phase("deserialize_request"):
            try:
                req = RequestInput.from_json_dict(json.loads(body))
            except (json.JSONDecodeError, TypeError, ValueError) as e:
                raise BadRequest(f"bad request body: {e}") from e

        with phase("validate_request"):
            vi = preprocess_and_validate_request(
                req,
                self.jwk_cache,
                self.jwk_fetcher.get_federated_jwk if self.jwk_fetcher else None,
            )

        with phase("derive_circuit_input_signals"):
            signals, public_inputs_hash = derive_circuit_input_signals(
                self.circuit_config, vi, self.config.max_committed_epk_bytes
            )

        with phase("generate_witness"):
            kw = witness_kwargs(signals)
            if self.witness_prog is not None:
                w64 = self.witness_prog.compute_witness(**kw)
                if self.config.enable_debug_checks:
                    bad = self.witness_prog.check_witness(w64)
                    if bad is not None:
                        raise InternalError(f"witness violates constraint {bad}")
                w_np = self.witness_prog.witness_limbs(w64)
            else:
                w = self.cs.compute_witness(**kw)
                if self.config.enable_debug_checks:
                    bad = self.cs.check_witness(w)
                    if bad is not None:
                        raise InternalError(f"witness violates constraint {bad}")
                w_np = self.cs.witness_np(w)

        with phase("generate_proof"):
            if self.batch_prover is not None:
                # concurrent requests coalesce into one vmapped device sweep;
                # no global mutex (the limit prover_state.rs:21 lifts here)
                proof = self.batch_prover.prove(w_np)
            else:
                with self.prove_lock:  # prover_handler.rs:266-268
                    proof = self.prover.prove(w_np)

        with phase("deserialize_proof"):
            proof_json = proof.to_json_dict()

        with phase("verify_proof"):  # defense in depth (prover_handler.rs:329-336)
            from ..groth16.pairing import verify_groth16

            if not verify_groth16(self.vk, [public_inputs_hash], proof_json):
                # transient device faults happen (one observed mid-round-5
                # under heavy compile churn); the re-verify exists exactly
                # to catch them, so retry the device work once before
                # failing the request
                PROOFS_TOTAL.inc(outcome="verify_failed")
                if self.batch_prover is not None:
                    proof = self.batch_prover.prove(w_np)
                else:
                    with self.prove_lock:
                        proof = self.prover.prove(w_np)
                proof_json = proof.to_json_dict()
                if not verify_groth16(self.vk, [public_inputs_hash], proof_json):
                    PROOFS_TOTAL.inc(outcome="verify_failed")
                    raise InternalError("generated proof failed verification")

        with phase("training_wheels_sign"):
            msg = proof_and_statement_bytes(proof_json, public_inputs_hash)
            tw_sig = self.tw_keypair.sign(msg)
            # verify our own signature before responding (prover_handler.rs:216-221)
            if not self.tw_keypair.verify(msg, tw_sig):
                raise InternalError("training-wheels signature self-check failed")

        with phase("build_response"):
            from .bcs import ephemeral_signature_bcs

            PROOFS_TOTAL.inc(outcome="success")
            resp = success_response(
                proof_json, public_inputs_hash, ephemeral_signature_bcs(tw_sig).hex()
            )
        return resp

#!/usr/bin/env python3
"""Smoke test of the keyless prover service on one NVIDIA GPU.

Run from the repository root, with the card to itself:

    python3 chip_smoke.py

Phases, in one process that owns the card:

1. device: refuse unless JAX's first device is a GPU; print the card's
   name and power limit as nvidia-smi reports them;
2. kernels against the plain references, at real widths, bit for bit:
   mont_mul (Fr and Fq, 2^22 rows, also under TF32-default matmul
   precision), the prover's NTT (2^21 x 3 round trip; forward transform vs
   the host NTT at 2^14), and the MSM on G1 and G2 at the prover's table
   sizes (2^21 and 2^20 rows, 2^16 of them live; the proof's sparse-witness
   and uniform scalar mixes) vs host curve ints. The checks compile and run
   in threads beside the set-up of phase 3;
3. main path at the production KeylessConfig (2^21 domain): build or load
   the setup, start the HTTP service on a localhost port, send three
   /v0/prove requests (one cold, two warm); check each proof against the
   VK and each training-wheels signature.

The last line of stdout is one JSON object: {"ok": true, "device": {...}}.
Any failed phase raises, so the process exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import hashlib
import http.client
import json
import os
import random
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SETUP_ROOT = os.path.join(REPO, ".cache", "setups")
# the prover's padded MSM table rows at the production circuit: the G1
# tables pad to 2^21 rows, G2 (B2) to 2^20, so the checks compile the very
# graphs the prover runs
G1_ROWS, G2_ROWS = 1 << 21, 1 << 20


def log(msg: str, **kv) -> None:
    print(json.dumps({"smoke": msg, **kv}), flush=True)


# ---- phase 1: device ---------------------------------------------------------


def device_check(jax) -> object:
    """The first JAX device, which must be a GPU (no CPU fallback)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}")
    return dev


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---- RS256 (PKCS#1 v1.5 over SHA-256) with a seeded RSA-2048 key ------------


def _is_probable_prime(n: int, rng: random.Random) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d, s = d // 2, s + 1
    for _ in range(40):
        x = pow(rng.randrange(2, n - 1), d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def rsa_keypair(seed: int, bits: int = 2048, e: int = 65537) -> tuple[int, int]:
    """Seeded RSA key (n, d) from two random probable primes."""
    rng = random.Random(seed)

    def prime(b: int) -> int:
        while True:
            c = rng.getrandbits(b) | (3 << (b - 2)) | 1
            if (c - 1) % e and _is_probable_prime(c, rng):
                return c

    p, q = prime(bits // 2), prime(bits // 2)
    return p * q, pow(e, -1, (p - 1) * (q - 1))


_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")


def rs256_sign(n: int, d: int, message: bytes) -> bytes:
    k = (n.bit_length() + 7) // 8
    t = _DIGEST_INFO + hashlib.sha256(message).digest()
    em = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    return pow(int.from_bytes(em, "big"), d, n).to_bytes(k, "big")


# ---- phase 2: kernels vs plain references ------------------------------------


def timed(jax, fn, *args):
    """(result, seconds) of one call, synced with block_until_ready."""
    t = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t


def _random_field(rng: np.random.Generator, p: int, n: int) -> np.ndarray:
    """(n, 16) u32 limbs of uniform values < p (top limb kept below p's)."""
    limbs = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
    limbs[:, 15] = rng.integers(0, p >> 240, size=n, dtype=np.uint32)
    return limbs


def check_mont_mul(jax, seed: int, rows: int = 1 << 22) -> dict:
    import jax.numpy as jnp

    from keyless_zk_tpu.fields import jax_field as jf
    from keyless_zk_tpu.fields.limbs import limbs_to_ints

    rng = np.random.default_rng(seed)
    res = {}
    sample = rng.choice(rows, min(rows, 256), replace=False)
    for spec in (jf.FR, jf.FQ):
        a, b = (_random_field(rng, spec.p, rows) for _ in range(2))
        da, db = jnp.asarray(a), jnp.asarray(b)
        want = [
            x * y * spec.r_inv % spec.p
            for x, y in zip(limbs_to_ints(a[sample]), limbs_to_ints(b[sample]))
        ]
        out, t_cold = timed(jax, jf.mont_mul, da, db, spec)
        out, t_warm = timed(jax, jf.mont_mul, da, db, spec)
        if limbs_to_ints(np.asarray(out)[sample]) != want:
            raise AssertionError(f"mont_mul {spec.name} differs from host ints")
        # XLA may run f32 contractions in TF32 when the default precision
        # says so; the limb products rely on Precision.HIGHEST staying exact
        with jax.default_matmul_precision("tensorfloat32"):
            tf32 = jax.block_until_ready(jf.mont_mul(da, db, spec))
        if not bool(jnp.array_equal(tf32, out)):
            raise AssertionError(f"mont_mul {spec.name} inexact under TF32 default")
        res[spec.name] = {"cold_s": t_cold, "warm_s": t_warm,
                          "mul_per_s": rows / t_warm}
    return res


def check_ntt(jax, seed: int, log_n: int = 21, log_small: int = 14) -> dict:
    import jax.numpy as jnp

    from keyless_zk_tpu.fields import bn254
    from keyless_zk_tpu.fields import jax_field as jf
    from keyless_zk_tpu.ops.ntt import get_plan, host_ntt

    rng = np.random.default_rng(seed)
    t = time.perf_counter()
    plan = get_plan(log_n)
    t_plan = time.perf_counter() - t
    x = jnp.asarray(_random_field(rng, jf.FR.p, 3 << log_n).reshape(3, 1 << log_n, 16))
    y, t_ntt_cold = timed(jax, plan.ntt, x)
    y, t_ntt = timed(jax, plan.ntt, x)
    back, t_intt_cold = timed(jax, plan.intt, y)
    back, t_intt = timed(jax, plan.intt, y)
    if not bool(jnp.array_equal(back, x)):
        raise AssertionError(f"NTT 2^{log_n} x 3 round trip differs")
    vals = [int(v) for v in rng.integers(0, 1 << 62, 1 << log_small)]
    small = get_plan(log_small)
    got = jf.decode_ints(small.ntt(jf.encode_ints(vals, jf.FR, mont=True)), jf.FR, mont=True)
    if got != host_ntt(vals, bn254.fr_root_of_unity(log_small)):
        raise AssertionError(f"NTT 2^{log_small} differs from the host NTT")
    return {"plan_s": t_plan, "ntt_cold_s": t_ntt_cold, "ntt_s": t_ntt,
            "intt_cold_s": t_intt_cold, "intt_s": t_intt}


def check_msm(jax, seed: int, group: str, rows: int, mix: str,
              live: int = 1 << 16) -> dict:
    """MSM vs host ints, at the prover's own graph shapes: `rows` table rows
    (the production tables pad to 2^21 G1 and 2^20 G2 rows), of which
    `live` are points k_i*G from the setup's fixed-base kernel (spot-checked
    on the host) and the rest infinity. The reference sum is then one host
    scalar multiplication: sum_i s_i*k_i*G = (sum_i s_i*k_i mod r)*G.

    `mix` is "sparse", the witness MSMs' (~94% bit-valued scalars at
    c=_SPARSE_C), or "uniform", MSM_H's (uniform scalars on every row,
    default c)."""
    import jax.numpy as jnp

    from keyless_zk_tpu.circuits.setup import _fixed_base_table
    from keyless_zk_tpu.curves import ref_curve
    from keyless_zk_tpu.curves.jacobian import G1_CURVE, G2_CURVE, JacPoint
    from keyless_zk_tpu.fields import bn254
    from keyless_zk_tpu.fields.limbs import ints_to_limbs, limbs_to_ints
    from keyless_zk_tpu.groth16.prover import _SPARSE_C
    from keyless_zk_tpu.ops.msm import msm, pad_table

    r = bn254.R_SCALAR
    rng = random.Random(seed)
    curve, ops, gen = (
        (G1_CURVE, ref_curve.G1, ref_curve.G1_GEN) if group == "g1"
        else (G2_CURVE, ref_curve.G2, ref_curve.G2_GEN)
    )
    ks = [rng.randrange(1, r) for _ in range(live)]
    for i in range(0, live - 1, 50):  # duplicate points, as zkey tables hold
        ks[i + 1] = ks[i]
    tbl = _fixed_base_table(ks, group, device_threshold=0)
    for i in (0, 1, live // 2, live - 1):  # the table itself vs host muls
        pt = curve.decode_jacobian(JacPoint(
            jnp.asarray(tbl.x[i : i + 1]), jnp.asarray(tbl.y[i : i + 1]),
            curve.ops.const(1, (1,)),
        ))[0]
        if pt != ops.mul(gen, ks[i]):
            raise AssertionError(f"{group} fixed-base point {i} differs")
    px, py, pinf = pad_table(*(jnp.asarray(a) for a in (tbl.x, tbl.y, tbl.inf)), rows)
    if mix == "sparse":
        scal = [rng.randrange(r) if rng.random() < 0.06 else rng.randrange(2)
                for _ in range(live)]
        sc, c = jnp.asarray(ints_to_limbs(scal)), _SPARSE_C
    else:
        limbs = _random_field(np.random.default_rng(seed), r, rows)
        scal, sc, c = limbs_to_ints(limbs[:live]), jnp.asarray(limbs), None

    def run(s):
        return msm(px, py, pinf, s, curve=curve, c=c)

    out, t_cold = timed(jax, run, sc)
    out, t_warm = timed(jax, run, sc)
    got = curve.decode_jacobian(JacPoint(*(a[None] for a in out)))[0]
    if got != ops.mul(gen, sum(s * k for s, k in zip(scal, ks)) % r):
        raise AssertionError(f"MSM {group} {mix} differs from host ints")
    return {f"{group}_{mix}": {"rows": rows, "cold_s": t_cold, "warm_s": t_warm}}


# ---- phase 3: the service's main path ---------------------------------------


def request_body(iss: str, kid: str, rsa_n: int, rsa_d: int) -> bytes:
    from keyless_zk_tpu.input_processing.hashing import compute_nonce
    from keyless_zk_tpu.input_processing.jwt import b64url_encode

    epk = bytes([0x00, 0x20]) + bytes(range(32))  # BCS ed25519 epk
    blinder, pepper, exp_date, horizon, iat = 42, 76, 1700005000, 10_000_000, 1700000000
    header = json.dumps({"alg": "RS256", "typ": "JWT", "kid": kid}, separators=(",", ":"))
    payload = json.dumps(
        {"iss": iss, "aud": "smoke-aud", "sub": "user-1", "iat": iat,
         "nonce": str(compute_nonce(exp_date, epk, blinder))},
        separators=(",", ":"),
    )
    unsigned = b64url_encode(header.encode()) + "." + b64url_encode(payload.encode())
    jwt = unsigned + "." + b64url_encode(rs256_sign(rsa_n, rsa_d, unsigned.encode()))
    return json.dumps({
        "jwt_b64": jwt,
        "epk": epk.hex(),
        "epk_blinder": blinder.to_bytes(31, "little").hex(),
        "exp_date_secs": exp_date,
        "exp_horizon_secs": horizon,
        "pepper": pepper.to_bytes(31, "little").hex(),
        "uid_key": "sub",
    }).encode()


def build_state(seed: int, keyless_config):
    """The service state with its prover: the production setup is built
    (or loaded) through the content-addressed store, as the service does."""
    from keyless_zk_tpu.circuits.keyless_circuit import to_circuit_config
    from keyless_zk_tpu.service.config import ProverServiceConfig
    from keyless_zk_tpu.service.jwk import JwkCache
    from keyless_zk_tpu.service.prover_state import ProverServiceState
    from keyless_zk_tpu.service.training_wheels import TrainingWheelsKeyPair

    rng = random.Random(seed)
    state = ProverServiceState(
        config=ProverServiceConfig(resources_dir=SETUP_ROOT),
        circuit_config=to_circuit_config(keyless_config),
        keyless_config=keyless_config,
        tw_keypair=TrainingWheelsKeyPair.from_sk_hex(rng.randbytes(32).hex()),
        jwk_cache=JwkCache(),
    )
    state.init_prover_from_native_setup(persist=True)
    pk = state.prover.pk
    log("setup", startup_seconds=state.startup_seconds, n_vars=pk.n_vars,
        domain_size=pk.domain_size, pairing_backend=state.pairing_backend,
        witness_engine="native" if state.witness_prog is not None else "python")
    return state


def serve_requests(seed: int, state) -> dict:
    """Start the HTTP service on a localhost port and send three /v0/prove
    requests; check every proof against the VK and every training-wheels
    signature."""
    from keyless_zk_tpu.groth16.pairing import verify_groth16
    from keyless_zk_tpu.groth16.prover import Proof
    from keyless_zk_tpu.service.bcs import ephemeral_signature_from_bcs
    from keyless_zk_tpu.service.jwk import RsaJwk
    from keyless_zk_tpu.service.metrics import PROOFS_TOTAL, PROVE_BREAKDOWN_SECONDS
    from keyless_zk_tpu.service.server import start_prover_service
    from keyless_zk_tpu.service.training_wheels import proof_and_statement_bytes
    from keyless_zk_tpu.tooling.onchain_vk import decompress_g1, decompress_g2

    iss, kid = "smoke.oidc.provider", "smoke-kid"
    rsa_n, rsa_d = rsa_keypair(seed)
    state.jwk_cache.insert(iss, RsaJwk(kid=kid, n=rsa_n))
    body = request_body(iss, kid, rsa_n, rsa_d)

    rejected = PROOFS_TOTAL.value(outcome="verify_failed")
    srv = start_prover_service(state, 0)
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    requests = []
    trace_env = os.environ.get("KEYLESS_PROVE_TRACE")
    try:
        for i in range(3):
            # the last request syncs and logs each prover stage
            os.environ["KEYLESS_PROVE_TRACE"] = "1" if i == 2 else "0"
            before = PROVE_BREAKDOWN_SECONDS.sums()
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=1200)
            t = time.perf_counter()
            conn.request("POST", "/v0/prove", body, {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            latency = time.perf_counter() - t
            conn.close()
            if resp.status != 200:
                raise AssertionError(f"request {i}: HTTP {resp.status}: {data[:500]!r}")
            phases = {
                k[0]: v - before.get(k, 0.0) for k, v in PROVE_BREAKDOWN_SECONDS.sums().items()
            }
            out = json.loads(data)
            # the response carries the compressed proof: decompress it, check
            # it against the VK, and the training-wheels signature against
            # the service's public key
            proof_json = Proof(
                pi_a=decompress_g1(bytes(out["proof"]["a"])),
                pi_b=decompress_g2(bytes(out["proof"]["b"])),
                pi_c=decompress_g1(bytes(out["proof"]["c"])),
            ).to_json_dict()
            pih = int.from_bytes(bytes.fromhex(out["public_inputs_hash"]), "little")
            if not verify_groth16(state.vk, [pih], proof_json):
                raise AssertionError(f"request {i}: proof does not verify against the VK")
            sig = ephemeral_signature_from_bcs(bytes.fromhex(out["training_wheels_signature"]))
            if not state.tw_keypair.verify(proof_and_statement_bytes(proof_json, pih), sig):
                raise AssertionError(f"request {i}: training-wheels signature invalid")
            rec = {"request": i, "latency_s": latency, "phases_s": phases}
            log("prove", **rec)
            requests.append(rec)
    finally:
        srv.shutdown()
        srv.server_close()
        if trace_env is None:
            os.environ.pop("KEYLESS_PROVE_TRACE", None)
        else:
            os.environ["KEYLESS_PROVE_TRACE"] = trace_env
    # the service re-proves once when its own check rejects a proof; on the
    # card that would hide a faulty kernel, so any rejection fails the smoke
    if PROOFS_TOTAL.value(outcome="verify_failed") != rejected:
        raise AssertionError("the service rejected a proof it generated")
    warm = [r["phases_s"]["generate_proof"] for r in requests[1:]]
    return {
        "startup_seconds": state.startup_seconds,
        "first_compile_s": requests[0]["phases_s"]["generate_proof"] - min(warm),
        "requests": requests,
        "pairing_backend": state.pairing_backend,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "keyless_zk_tpu")):
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    sys.path.insert(0, REPO)

    from keyless_zk_tpu.utils.compile_cache import enable_compile_cache, set_xla_flags

    set_xla_flags()
    import jax

    from keyless_zk_tpu.circuits.keyless_circuit import KeylessConfig

    dev = device_check(jax)
    print(card_line(), flush=True)
    enable_compile_cache()
    log("device", platform=dev.platform, kind=dev.device_kind, count=len(jax.devices()))

    # The kernel checks compile the prover's own MSM and NTT graphs, so they
    # run beside the host-bound setup, each in its own thread (XLA compiles
    # them in parallel); the prover then finds them compiled.
    t0 = time.perf_counter()
    seed = args.seed

    def field_ntt():
        log("mont_mul", **check_mont_mul(jax, seed))
        log("ntt", **check_ntt(jax, seed))

    def msm_check(group, rows, mix):
        log("msm", **check_msm(jax, seed, group, rows, mix))

    def fail_fast(fut):
        # a failed check ends the run now, not after the set-up
        if fut.exception() is not None:
            traceback.print_exception(fut.exception())
            os._exit(1)

    with ThreadPoolExecutor(4) as pool:
        kernels = [pool.submit(field_ntt)] + [
            pool.submit(msm_check, *args)
            for args in (("g2", G2_ROWS, "sparse"), ("g1", G1_ROWS, "sparse"),
                         ("g1", G1_ROWS, "uniform"))
        ]
        for k in kernels:
            k.add_done_callback(fail_fast)
        state = build_state(seed, KeylessConfig())
        for k in kernels:
            k.result()
    log("kernels_and_setup_done", seconds=time.perf_counter() - t0)

    t = time.perf_counter()
    res = serve_requests(seed, state)
    stats = dev.memory_stats() or {}
    log("main_path_done", seconds=time.perf_counter() - t,
        total_seconds=time.perf_counter() - t0,
        first_compile_s=res["first_compile_s"],
        peak_bytes_in_use=stats.get("peak_bytes_in_use"),
        pairing_backend=res["pairing_backend"])
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

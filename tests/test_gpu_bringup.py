"""Checks of the GPU bring-up that run on the CPU, plus the card-only
kernel phase of chip_smoke.py (marker `gpu`, skipped without a card).

- the field multiply's f32 contractions must carry Precision.HIGHEST, or a
  TF32 default would round the limb products;
- the compile cache lands where JAX_COMPILATION_CACHE_DIR says, else at a
  fixed git-ignored directory in the checkout;
- chip_smoke.py refuses a CPU backend and a directory without the repo;
- chip_smoke.py's pure-Python RS256 signer agrees with the service's own
  verifier, and its service path runs on the CPU with the prover stubbed.
"""

import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("default", [None, "tensorfloat32"])
def test_product_cols_contractions_are_highest_precision(default):
    from keyless_zk_tpu.fields import jax_field as jf

    a = jnp.zeros((4, 16), jnp.uint32)
    with jax.default_matmul_precision(default):
        jaxpr = jax.make_jaxpr(lambda x, y: jf._product_cols(x, y, 33))(a, a)
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 2
    for e in dots:
        assert e.params["precision"] == (jax.lax.Precision.HIGHEST,) * 2


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "checkout"])
def test_compile_cache_placement(env_set, tmp_path, monkeypatch):
    from keyless_zk_tpu.utils import compile_cache

    if env_set:
        want = str(tmp_path / "jax-cache")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    else:
        want = os.path.join(REPO, ".cache", "xla")
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".cache/" in f.read().split()
    old = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert os.path.isdir(want)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu_or_repo(where, tmp_path):
    """On the CPU backend, and in a directory holding only the script, the
    smoke exits non-zero and prints no ok line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_device_check_refuses_cpu():
    smoke = _load_smoke()
    with pytest.raises(SystemExit):
        smoke.device_check(jax)


def test_rs256_signer_matches_service_verifier():
    from keyless_zk_tpu.service.jwk import RsaJwk
    from keyless_zk_tpu.service.training_wheels import verify_rs256

    smoke = _load_smoke()
    n, d = smoke.rsa_keypair(5)
    assert n.bit_length() == 2048
    assert smoke.rsa_keypair(5) == (n, d)  # seeded
    jwk = RsaJwk(kid="k", n=n)
    msg = b"eyJhbGciOiJSUzI1NiJ9.eyJzdWIiOiIxIn0"
    sig = int.from_bytes(smoke.rs256_sign(n, d, msg), "big")
    assert verify_rs256(jwk, msg, sig)
    assert not verify_rs256(jwk, msg + b"x", sig)


@pytest.mark.gpu
def test_smoke_kernels_on_gpu(gpu_device):
    """chip_smoke.py's kernel phase: mont_mul, the NTT and the MSM against
    the plain references at real widths, on the card."""
    smoke = _load_smoke()
    smoke.check_mont_mul(jax, 7)
    smoke.check_ntt(jax, 7)
    smoke.check_msm(jax, 7, "g1", smoke.G1_ROWS, "sparse")
    smoke.check_msm(jax, 7, "g1", smoke.G1_ROWS, "uniform")
    smoke.check_msm(jax, 7, "g2", smoke.G2_ROWS, "sparse")


def test_chip_smoke_serve_path_with_stub_prover(monkeypatch):
    """The smoke's main path on the CPU at the tests' SMALL circuit, with
    only the device prover and the pairing check stubbed: its RS256 JWT
    passes the service's validation, the native witness satisfies every
    constraint, and the smoke parses each response, decompresses the proof
    and checks the training-wheels signature."""
    from test_keyless_circuit import SMALL

    from keyless_zk_tpu.circuits.keyless_circuit import build_keyless_circuit
    from keyless_zk_tpu.circuits.witness_engine import CompiledWitnessProgram
    from keyless_zk_tpu.curves import ref_curve
    from keyless_zk_tpu.groth16 import pairing
    from keyless_zk_tpu.groth16.prover import Proof
    from keyless_zk_tpu.service.prover_state import ProverServiceState

    smoke = _load_smoke()
    g1, g2 = ref_curve.G1, ref_curve.G2
    proof = Proof(
        pi_a=g1.mul(ref_curve.G1_GEN, 3),
        pi_b=g2.mul(ref_curve.G2_GEN, 5),
        pi_c=g1.mul(ref_curve.G1_GEN, 7),
    )

    class StubProver:
        def __init__(self, n_vars):
            self.pk = type("pk", (), {"n_vars": n_vars, "domain_size": 0})()

        def prove(self, w):
            assert w.shape == (self.pk.n_vars, 16)
            return proof

    def init(self, rng=None, persist=False):
        self.cs = build_keyless_circuit(self.keyless_config)
        self.witness_prog = CompiledWitnessProgram(self.cs)
        self.config.enable_debug_checks = True  # the witness meets every constraint
        self.prover, self.vk = StubProver(self.cs.n_wires), {}
        self.check_pairing_backend()

    checked = []

    def verify(vk, public_inputs, proof_json):
        checked.append(public_inputs)
        return proof_json == proof.to_json_dict()

    monkeypatch.setattr(ProverServiceState, "init_prover_from_native_setup", init)
    monkeypatch.setattr(pairing, "verify_groth16", verify)
    res = smoke.serve_requests(7, smoke.build_state(7, SMALL))
    assert [r["request"] for r in res["requests"]] == [0, 1, 2]
    # the service and the smoke each checked all three proofs, with one
    # public-inputs hash
    assert len(checked) == 6 and len({p[0] for p in checked}) == 1

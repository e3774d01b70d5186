"""keyless_zk_tpu — a Groth16 proving stack for Aptos Keyless, in JAX.

A from-scratch re-design of the capabilities of aptos-labs/keyless-zk-proofs
(reference layout: rust-rapidsnark C++/asm numerics + Rust service) as an
idiomatic JAX/XLA stack:

- ``fields``   — BN254 Fr/Fq arithmetic as limb-decomposed uint32 vectors
                 (Montgomery form), batched over devices.
- ``curves``   — G1 (Fq) / G2 (Fq2) short-Weierstrass group ops in Jacobian
                 coordinates, fully batched.
- ``ops``      — the proving kernels: Pippenger MSM, coset NTT/iNTT,
                 Poseidon-BN254, SHA-256 (replaces multiexp.cpp / fft.cpp).
- ``groth16``  — snarkjs zkey/wtns parsing and the prover/verifier pipeline
                 (replaces groth16.cpp / fullprover.cpp).
- ``circuits`` — the circuit front-end: R1CS builder + witness generation
                 (replaces the circom-generated witness binaries).
- ``parallel`` — device-mesh sharding of MSM buckets and NTT stages.
- ``service``  — the prover service API surface (replaces prover-service/).
- ``utils``    — logging/config/io.
"""

__version__ = "0.1.0"

"""Prover service: the HTTP API layer of the stack.

Native replacement for the reference's Rust prover-service
(prover-service/src/): the same five endpoints (`/v0/prove`, `/about`,
`/config`, `/healthcheck`, `/cached/jwk` — request_handler/handler.rs:19-32),
the same request/response JSON (types.rs:24-57), training-wheels
validation + Ed25519 signing (training_wheels.rs), JWK refresh loops
(jwk_fetcher.rs), and Prometheus metrics on a dedicated port (metrics.rs).

The proving backend is the device Groth16 engine + native witness generation
instead of an FFI'd rapidsnark + circom witness subprocesses.
"""

"""Prover service binary.

Mirror of prover-service/src/main.rs:30-192: CLI parsing, training-wheels
key load, JWK fetcher spawn, state init, metrics server on a separate
port, then the main HTTP server.

    python -m keyless_zk_tpu.service.server \
        --config-file-path config.yml \
        --training-wheels-private-key-file-path tw_sk.hex
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .config import ProverServiceConfig
from .handler import handle_request
from .jwk import JwkCache, JwkFetcher
from .metrics import REGISTRY
from .prover_state import ProverServiceState
from .training_wheels import TrainingWheelsKeyPair


def _make_handler(state, max_inflight: int = 32, request_timeout: float = 30.0):
    """Handler with the backpressure the reference gets from tokio semantics:
    a bounded in-flight-request gate (503 + Retry-After when saturated) and
    a socket timeout so dead clients can't pin handler threads."""
    gate = threading.BoundedSemaphore(max_inflight)

    class Handler(BaseHTTPRequestHandler):
        timeout = request_timeout  # socket-level read timeout

        def _respond(self):
            if not gate.acquire(blocking=False):
                data = json.dumps({"error": "server saturated, retry later"}).encode()
                self.send_response(503)
                self.send_header("Retry-After", "1")
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            try:
                self._respond_inner()
            finally:
                gate.release()

        def _respond_inner(self):
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            status, headers, payload = handle_request(
                state, self.command, self.path, body
            )
            data = json.dumps(payload).encode()
            self.send_response(status)
            for k, v in headers.items():
                self.send_header(k, v)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        do_GET = do_POST = do_OPTIONS = _respond

        def log_message(self, fmt, *args):  # JSON-line logging like the reference
            print(
                json.dumps({"http": fmt % args, "path": self.path}),
                file=sys.stderr,
            )

    return Handler


def _make_metrics_handler():
    class MetricsHandler(BaseHTTPRequestHandler):
        def do_GET(self):
            data = REGISTRY.expose().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    return MetricsHandler


def start_metrics_server(port: int) -> ThreadingHTTPServer:
    """metrics.rs:199-215: a second HTTP server for Prometheus scrapes."""
    srv = ThreadingHTTPServer(("0.0.0.0", port), _make_metrics_handler())
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def start_prover_service(state, port: int) -> ThreadingHTTPServer:
    srv = ThreadingHTTPServer(
        ("0.0.0.0", port),
        _make_handler(
            state,
            max_inflight=state.config.max_inflight_requests,
            request_timeout=state.config.request_timeout_secs,
        ),
    )
    return srv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="keyless-zk-tpu-prover-service")
    ap.add_argument("--config-file-path", required=True)
    ap.add_argument("--training-wheels-private-key-file-path", required=True)
    ap.add_argument(
        "--no-prover",
        action="store_true",
        help="serve endpoints without initializing the proving backend",
    )
    args = ap.parse_args(argv)

    config = ProverServiceConfig.from_yaml(args.config_file_path)
    with open(args.training_wheels_private_key_file_path) as f:
        tw = TrainingWheelsKeyPair.from_sk_hex(f.read().strip())

    jwk_cache = JwkCache()
    fetcher = JwkFetcher(jwk_cache, refresh_secs=config.jwk_refresh_rate_secs)
    fetcher.start(config.oidc_providers)

    from ..circuits.keyless_circuit import KeylessConfig, to_circuit_config

    kc = KeylessConfig()
    state = ProverServiceState(
        config=config,
        circuit_config=to_circuit_config(kc),
        keyless_config=kc,
        tw_keypair=tw,
        jwk_cache=jwk_cache,
        jwk_fetcher=fetcher,
    )
    if not args.no_prover:
        from ..utils.compile_cache import enable_compile_cache, set_xla_flags

        set_xla_flags()
        enable_compile_cache()
        print("initializing prover (native setup)...", file=sys.stderr)
        state.init_prover_from_native_setup(persist=True)

    start_metrics_server(config.metrics_port)
    srv = start_prover_service(state, config.port)
    print(
        json.dumps({"listening": config.port, "metrics": config.metrics_port}),
        file=sys.stderr,
    )
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Prometheus-style metrics (native, no client dependency).

Mirror of prover-service/src/metrics.rs: request-handling latency
histograms labeled by endpoint/method/code (:103-111), the 9-phase prove
breakdown histogram (:31-39, 92-100), JWK fetch timing (:55-63), and JWT
attribute size histograms (:114-122), exposed in Prometheus text format on
a dedicated port (:199-215).
"""

from __future__ import annotations

import threading
from collections import defaultdict

# the reference's exponential buckets: 1us .. ~16s (metrics.rs:66-71)
DEFAULT_BUCKETS = tuple(1e-6 * (2**i) for i in range(25))

PROVE_PHASES = (
    # metrics.rs:31-39
    "deserialize_request",
    "validate_request",
    "derive_circuit_input_signals",
    "generate_witness",
    "generate_proof",
    "deserialize_proof",
    "verify_proof",
    "training_wheels_sign",
    "build_response",
)


class Histogram:
    def __init__(self, name: str, help_: str, label_names=(), buckets=DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._counts: dict = defaultdict(lambda: [0] * (len(self.buckets) + 1))
        self._sums: dict = defaultdict(float)

    def observe(self, value: float, **labels) -> None:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            counts = self._counts[key]
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[key] += value

    def sums(self) -> dict:
        """Snapshot of per-label-key summed observations (seconds)."""
        with self._lock:
            return dict(self._sums)

    def expose(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            for key, counts in self._counts.items():
                base = ",".join(
                    f'{n}="{v}"' for n, v in zip(self.label_names, key)
                )
                cum = 0
                for b, c in zip(self.buckets, counts):
                    cum += c
                    sep = "," if base else ""
                    lines.append(f'{self.name}_bucket{{{base}{sep}le="{b:g}"}} {cum}')
                cum += counts[-1]
                sep = "," if base else ""
                lines.append(f'{self.name}_bucket{{{base}{sep}le="+Inf"}} {cum}')
                lines.append(f"{self.name}_count{{{base}}} {cum}")
                lines.append(f"{self.name}_sum{{{base}}} {self._sums[key]:g}")
        return "\n".join(lines)


class Counter:
    def __init__(self, name: str, help_: str, label_names=()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._values: dict = defaultdict(int)

    def inc(self, amount: int = 1, **labels) -> None:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            self._values[key] += amount

    def value(self, **labels) -> int:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            return self._values.get(key, 0)

    def expose(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            for key, v in self._values.items():
                base = ",".join(f'{n}="{val}"' for n, val in zip(self.label_names, key))
                lines.append(f"{self.name}{{{base}}} {v}")
        return "\n".join(lines)


class Registry:
    def __init__(self):
        self._metrics: list = []

    def histogram(self, name, help_, label_names=(), buckets=DEFAULT_BUCKETS) -> Histogram:
        m = Histogram(name, help_, label_names, buckets)
        self._metrics.append(m)
        return m

    def counter(self, name, help_, label_names=()) -> Counter:
        m = Counter(name, help_, label_names)
        self._metrics.append(m)
        return m

    def expose(self) -> str:
        return "\n".join(m.expose() for m in self._metrics) + "\n"


REGISTRY = Registry()

REQUEST_HANDLING_SECONDS = REGISTRY.histogram(
    "keyless_prover_service_request_handling_seconds",
    "Time handling HTTP requests",
    ("endpoint", "method", "code"),
)
PROVE_BREAKDOWN_SECONDS = REGISTRY.histogram(
    "keyless_prover_service_prove_request_breakdown_seconds",
    "Per-phase prove latency",
    ("phase",),
)
JWK_FETCH_SECONDS = REGISTRY.histogram(
    "keyless_prover_service_jwk_fetch_seconds",
    "JWK fetch latency",
    ("issuer", "succeeded"),
)
JWT_ATTRIBUTE_SIZES = REGISTRY.histogram(
    "keyless_prover_service_jwt_attribute_sizes",
    "Sizes of JWT attributes seen in requests",
    ("attribute",),
    buckets=tuple(float(2**i) for i in range(16)),
)
PROOFS_TOTAL = REGISTRY.counter(
    "keyless_prover_service_proofs_total", "Proofs attempted", ("outcome",)
)
PAIRING_BACKEND = REGISTRY.counter(
    "keyless_prover_service_pairing_backend",
    "Groth16 verification pairing backend selected at startup",
    ("backend",),
)

"""Benchmark suite for the Groth16 stack (BASELINE.md configs[1-4]).

Every metric runs in its OWN SUBPROCESS, one at a time, so a hang is
killed for real (the child's device client dies with it), a crash is
contained, and each metric starts with an empty device; the parent never
imports JAX, so only one process holds the card at a time. ONE global
deadline (BENCH_BUDGET_S, default 1150 s) governs the run; every child's
watchdog is clamped to the time remaining. The device pre-flight fails
within seconds unless JAX's first device is a GPU, and every record names
the platform, device kind and device count it was measured on.

Anchors for vs_baseline derive from the reference profile (SURVEY §6): a
rapidsnark-class 16-core CPU proves the full 1.38M-constraint circuit in
single-digit seconds. Decomposing that profile (4x 1.34M-point G1/G2 MSMs +
1x 2.1M MSM + 6x 2^21 transforms in ~3 s):

  msm_g1_2^16  ~100 ms      msm_g1_2^20   ~1.6 s (16x points)
  msm_g2_2^16  ~300 ms      (G2 ~3x G1, multiexp.cpp:311-312)
  ntt_2^16     ~4 ms        ntt_2^21      ~125 ms
  mont_mul     ~1.0e9/s     (16 cores x ~65M 254-bit Montgomery muls/s)
  full proof   ~3 s         (fullprover.cpp:226-244 per-proof ms)

Env knobs: BENCH_QUICK=1 -> headline only; BENCH_SKIP_FULL=1 -> skip the
full keyless proof; BENCH_BUDGET_S=<seconds> -> global deadline.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.abspath(__file__))
POINT_CACHE = os.path.expanduser("~/.cache/keyless_zk_tpu/bench")

# (metric, budget_s, headline) in importance order. Budgets are upper
# bounds; the global deadline clamps them.
METRICS = [
    ("msm_g1_2^16", 300, True),
    ("full_keyless_proof", 600, False),
    ("msm_g1_2^20", 240, False),
    ("msm_g2_2^16", 240, False),
    ("ntt_2^16", 120, False),
    ("ntt_2^21", 120, False),
    ("mont_mul_fr", 90, False),
    ("ec_madd_g1", 90, False),
    ("proofs_per_sec", 300, False),
]


# --------------------------- child-side helpers ------------------------------

def sync(out):
    import jax

    return jax.block_until_ready(out)


def _device() -> dict:
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}


def timeit(fn, iters=3, warmup=1):
    for _ in range(warmup):
        sync(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        sync(fn())
        times.append(time.perf_counter() - t0)
    return min(times)


def emit(metric, value, unit, baseline, **extra):
    rec = {
        "metric": metric,
        "value": round(value, 3),
        "unit": unit,
        "vs_baseline": round(baseline / value, 3) if baseline else None,
    }
    rec.update(extra)
    rec["device"] = _device()
    print(json.dumps(rec), flush=True)
    return rec


def cached_points(n: int, seed: int, g2: bool = False):
    """Random affine points, generated once per (n, curve) and disk-cached.

    Generation (a 254-step on-device double-and-add, ops/testgen.py) costs
    more than the measurement at G2/2^20 sizes; it must never be repaid."""
    import numpy as np
    import jax.numpy as jnp

    from keyless_zk_tpu.curves.jacobian import G1_CURVE, G2_CURVE
    from keyless_zk_tpu.ops.testgen import random_points

    tag = "g2" if g2 else "g1"
    path = os.path.join(POINT_CACHE, f"points_{tag}_{n}_s{seed}.npz")
    if os.path.exists(path):
        z = np.load(path)
        return jnp.asarray(z["x"]), jnp.asarray(z["y"]), jnp.asarray(z["inf"])
    px, py, pinf = random_points(n, seed=seed, curve=G2_CURVE if g2 else G1_CURVE)
    os.makedirs(POINT_CACHE, exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, x=np.asarray(px), y=np.asarray(py), inf=np.asarray(pinf))
    os.replace(tmp, path)
    return px, py, pinf


def _child(metric: str) -> None:
    """Measure ONE metric and print its JSON record (run in a subprocess)."""
    from keyless_zk_tpu.utils.compile_cache import enable_compile_cache, set_xla_flags

    set_xla_flags()
    enable_compile_cache()

    if metric == "devices":
        dev = _device()
        if dev["platform"] != "gpu":
            raise SystemExit(f"no GPU: JAX's first device is {dev['platform']}")
        print(json.dumps({"devices": dev}), flush=True)
        return

    import jax

    from keyless_zk_tpu.curves.jacobian import G1_CURVE, G2_CURVE
    from keyless_zk_tpu.fields import jax_field as jf
    from keyless_zk_tpu.fields.jax_field import FR
    from keyless_zk_tpu.ops.msm import msm
    from keyless_zk_tpu.ops.ntt import get_plan
    from keyless_zk_tpu.ops.testgen import random_scalars

    if metric == "msm_g1_2^16":
        n = 1 << 16
        px, py, pinf = cached_points(n, seed=42)
        scalars = random_scalars(n, seed=43)
        jax.block_until_ready((px, py, scalars))
        t = timeit(lambda: msm(px, py, pinf, scalars, curve=G1_CURVE))
        emit(metric, t * 1e3, "ms", 100.0)

    elif metric == "full_keyless_proof":
        sys.path.insert(0, _REPO)
        from scripts.full_prove import run_full_prove

        res = run_full_prove(config="full", repeat=2)
        emit(
            metric,
            res["prove_ms"],
            "ms",
            3000.0,
            phases=res.get("phases"),
            cold_ms=res.get("cold_ms"),
        )

    elif metric == "msm_g1_2^20":
        n20 = 1 << 20
        px20, py20, pinf20 = cached_points(n20, seed=45)
        sc20 = random_scalars(n20, seed=46)
        jax.block_until_ready((px20, sc20))
        t20 = timeit(lambda: msm(px20, py20, pinf20, sc20, curve=G1_CURVE), iters=2)
        emit(metric, t20 * 1e3, "ms", 1600.0)

    elif metric == "msm_g2_2^16":
        n = 1 << 16
        qx, qy, qinf = cached_points(n, seed=44, g2=True)
        scalars = random_scalars(n, seed=43)
        jax.block_until_ready((qx, scalars))
        tg2 = timeit(lambda: msm(qx, qy, qinf, scalars, curve=G2_CURVE), iters=2)
        emit(metric, tg2 * 1e3, "ms", 300.0)

    elif metric == "ntt_2^16":
        plan16 = get_plan(16)
        poly = random_scalars(1 << 16, seed=3)
        ntt16 = jax.jit(plan16.ntt)
        tn = timeit(lambda: ntt16(poly))
        emit(metric, tn * 1e3, "ms", 4.0)

    elif metric == "ntt_2^21":
        plan21 = get_plan(21)
        poly21 = random_scalars(1 << 21, seed=4)
        ntt21 = jax.jit(plan21.ntt)
        tn21 = timeit(lambda: ntt21(poly21), iters=2)
        emit(metric, tn21 * 1e3, "ms", 125.0)

    elif metric == "mont_mul_fr":
        m = 1 << 22
        a = random_scalars(m, seed=1).reshape(m, 16)
        b = random_scalars(m, seed=2).reshape(m, 16)
        jax.block_until_ready((a, b))
        mm = jax.jit(lambda x, y: jf.mont_mul(x, y, FR))
        tm = timeit(lambda: mm(a, b))
        gops = m / tm / 1e9
        # a rate: vs_baseline is measured / anchor (~1e9 muls/s, 16 cores)
        emit(metric, gops, "Gops/s", None, vs_baseline=round(gops / 1.0, 3))

    elif metric == "ec_madd_g1":
        n = 1 << 16
        px, py, pinf = cached_points(n, seed=42)
        acc = G1_CURVE.from_affine(px, py, pinf)
        madd = jax.jit(lambda p, x, y, i: G1_CURVE.add_mixed(p, x, y, i))
        te = timeit(lambda: madd(acc, px, py, pinf))
        emit(metric, n / te / 1e6, "Mops/s", None)

    elif metric == "proofs_per_sec":
        # configs[4]: batched throughput at the FULL keyless setup (the
        # reference's per-process mutex caps this at 1/proof-latency,
        # prover_state.rs:21). B=1 reuses the single-prover graphs; B>1
        # runs the batch-offset flat-stream MSMs (ops/msm.py msm_batch).
        sys.path.insert(0, _REPO)
        from scripts.bench_batch import run_batch_bench

        res = run_batch_bench(config="full", iters=6, batches=(1, 2, 4))
        emit(
            metric, res["proofs_per_sec"], "proofs/s", None,
            batch=res.get("batch"), results=res.get("results"),
        )

    else:
        raise SystemExit(f"unknown metric {metric}")


# --------------------------- parent orchestration ----------------------------

def _error_rec(metric, err):
    return {
        "metric": metric, "error": str(err)[:300],
        "value": None, "unit": None, "vs_baseline": None,
    }


def _run_child(metric: str, budget_s: float, results: list) -> dict | None:
    """Run one metric subprocess; returns its record (or an error record).

    The child is its own process group; on timeout the whole group gets
    SIGKILL, which tears down its device client and frees the chip."""
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--one", metric],
        stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL,
        text=True,
        start_new_session=True,
        cwd=_REPO,
    )
    rec = None
    try:
        out, _ = proc.communicate(timeout=budget_s)
        for line in out.splitlines():
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                cand = json.loads(line)
            except json.JSONDecodeError:
                continue
            if cand.get("metric") == metric or "devices" in cand:
                rec = cand
        if rec is None:
            rec = _error_rec(metric, f"child exited rc={proc.returncode} with no record")
    except subprocess.TimeoutExpired:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            proc.kill()
        proc.wait()
        rec = _error_rec(metric, f"watchdog timeout after {budget_s:.0f}s (child killed)")
    results.append(rec)
    print(json.dumps(rec), flush=True)
    try:
        with open(os.path.join(_REPO, "BENCH_LOCAL.json"), "w") as f:
            json.dump(results, f, indent=1)
    except OSError:
        pass
    return rec


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        _child(sys.argv[2])
        return 0

    deadline = time.monotonic() + float(os.environ.get("BENCH_BUDGET_S", "1150"))
    results: list = []
    headline = None

    dev_rec = _run_child("devices", min(60.0, deadline - time.monotonic()), results)
    if not dev_rec or "devices" not in dev_rec:
        print(json.dumps(_error_rec("msm_g1_2^16", "device backend unavailable")), flush=True)
        return 0

    quick = os.environ.get("BENCH_QUICK") == "1"
    skip_full = os.environ.get("BENCH_SKIP_FULL") == "1"

    for metric, budget, is_headline in METRICS:
        if metric == "full_keyless_proof" and skip_full:
            continue
        remaining = deadline - time.monotonic()
        if remaining < 45:
            print(
                json.dumps(_error_rec(metric, f"skipped: global budget exhausted ({remaining:.0f}s left)")),
                flush=True,
            )
            continue
        rec = _run_child(metric, min(budget, remaining), results)
        if is_headline and rec and rec.get("value") is not None:
            headline = rec
        if quick and is_headline:
            break

    if headline is not None:
        print(json.dumps(headline), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

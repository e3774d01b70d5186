"""Native Groth16 setup: R1CS -> proving key + verification key.

Replaces the external `snarkjs groth16 setup` step of the reference's
procurement pipeline (scripts/python/setups/testing_setup.py:62-69) with a
direct in-process setup.  Like the reference's testing setup it is a
1-party untrusted ceremony: toxic waste (tau, alpha, beta, gamma, delta)
is sampled locally and discarded.

Outputs plug straight into our prover:

- a :class:`~keyless_zk_tpu.groth16.zkey.ProvingKey` with the exact zkey
  semantics the prover consumes (coefficient table = sparse A/B matrix
  rows + snarkjs's public-input binding rows; Montgomery-stored values);
- a snarkjs-shape verification-key dict (cf. toy_vk.json) accepted by
  :func:`keyless_zk_tpu.groth16.pairing.verify_groth16`.

The heavy part of setup is ~5*nVars + domain fixed-base scalar
multiplications; they run as batched windowed fixed-base kernels on the
device (32 vector steps over a precomputed window table), not nVars
sequential host muls.

Representation bookkeeping (verified bit-exact against toy_1.zkey):
zkey coefficient records store c*R^2 — snarkjs holds matrix entries in
Montgomery form (c*R) internally and Montgomery-encodes them again on
write.  Feeding that through our prover's pipeline makes the a/b vectors
Montgomery (true*R) and the final from_mont lands MSM_H's scalars on the
*true* coset evaluations of a*b - c, so the H basis is factor-free:

    H_k = [ L_k(tau/eta) * (tau^n - 1) / (delta * (eta^n - 1)) ] G1

with Z(eta*w^k) = eta^n - 1 = -2 the constant coset vanishing value.
This makes MSM_H = [ h(tau) * Z(tau) / delta ] G1 exactly — the same
contract snarkjs's hExps satisfy for rapidsnark (groth16.cpp:264-286).
"""

from __future__ import annotations

import functools
import itertools
import secrets
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..curves import ref_curve
from ..fields import bn254
from ..fields.limbs import ints_to_limbs
from ..groth16.zkey import G1Table, G2Table, ProvingKey
from ..utils.logging import Span

P = bn254.R_SCALAR
R256 = 1 << 256


def _batch_inv(xs: list[int]) -> list[int]:
    """Montgomery batch inversion: one modular inverse for the whole list."""
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % P
    inv = pow(prefix[n], -1, P)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv % P
        inv = inv * xs[i] % P
    return out


# fixed-base window width: each point is the sum of ceil(254/8) = 32
# table entries d * 2^(8j) * G, one batched mixed add per window
_FB_BITS = 8
_FB_WINDOWS = -(-254 // _FB_BITS)


@functools.lru_cache(maxsize=2)
def _window_table(group: str):
    """Host table T[j][d] = d * 2^(8j) * G (None for d == 0), as the
    device's Montgomery limb arrays (x, y, inf) of shape (windows, 2^8, ...)."""
    from ..curves.jacobian import G1_CURVE, G2_CURVE

    ops = ref_curve.G1 if group == "g1" else ref_curve.G2
    base = ref_curve.G1_GEN if group == "g1" else ref_curve.G2_GEN
    rows = []
    for _ in range(_FB_WINDOWS):
        row = [None]
        for _ in range(1, 1 << _FB_BITS):
            row.append(ops.add(row[-1], base))
        rows.append(row)
        base = ops.add(row[-1], base)  # 2^8 * base
    curve = G1_CURVE if group == "g1" else G2_CURVE
    x, y, inf = curve.encode_affine([p for row in rows for p in row])
    shape = (_FB_WINDOWS, 1 << _FB_BITS)
    return (
        x.reshape(*shape, *x.shape[1:]),
        y.reshape(*shape, *y.shape[1:]),
        inf.reshape(shape),
    )


@functools.partial(jax.jit, static_argnames="curve")
def _fixed_base_chunk(limbs, tx, ty, tinf, *, curve):
    """(n, 16) standard-form scalars -> affine (x, y, inf) of k*G: 32
    windowed mixed adds from the window table, then one batched inversion.
    Infinity rows come out as all-zero coordinates."""
    n = limbs.shape[0]
    mask = jnp.uint32((1 << _FB_BITS) - 1)

    def body(j, acc):
        bit = j * _FB_BITS
        d = ((jnp.take(limbs, bit // 16, axis=1) >> (bit % 16)) & mask).astype(jnp.int32)
        return curve.add_mixed(
            acc, jnp.take(tx[j], d, axis=0), jnp.take(ty[j], d, axis=0), tinf[j][d]
        )

    acc = jax.lax.fori_loop(0, _FB_WINDOWS, body, curve.infinity((n,)))
    x, y, inf = curve.to_affine(acc)
    zero = curve.ops.zeros((n,))
    return curve.ops.select(inf, zero, x), curve.ops.select(inf, zero, y), inf


def _fixed_base_table(
    scalars: list[int], group: str, device_threshold: int = 512, chunk: int = 1 << 16
):
    """[k_i * G] for the G1/G2 generator as a G1Table/G2Table of Montgomery
    limbs; on the device beyond a threshold, else host ints.

    Work is cut into fixed-size chunks (padded to `chunk`, or to the whole
    list when it is shorter) so one compiled shape serves any table size
    and device memory stays bounded.
    """
    from ..curves.jacobian import G1_CURVE, G2_CURVE

    if len(scalars) <= device_threshold:
        ops = ref_curve.G1 if group == "g1" else ref_curve.G2
        gen = ref_curve.G1_GEN if group == "g1" else ref_curve.G2_GEN
        pts = [ops.mul(gen, k) for k in scalars]
        return _g1_table(pts) if group == "g1" else _g2_table(pts)
    curve = G1_CURVE if group == "g1" else G2_CURVE
    tx, ty, tinf = _window_table(group)
    total = len(scalars)
    size = min(chunk, total)
    xs, ys, infs = [], [], []
    for start in range(0, total, size):
        part = scalars[start : start + size]
        limbs = ints_to_limbs([k % P for k in part] + [0] * (size - len(part)))
        x, y, inf = _fixed_base_chunk(jnp.asarray(limbs), tx, ty, tinf, curve=curve)
        xs.append(np.asarray(x)[: len(part)])
        ys.append(np.asarray(y)[: len(part)])
        infs.append(np.asarray(inf)[: len(part)])
    table = G1Table if group == "g1" else G2Table
    return table(x=np.concatenate(xs), y=np.concatenate(ys), inf=np.concatenate(infs))


@dataclass
class SetupResult:
    pk: ProvingKey
    vk: dict
    toxic: dict  # tau/alpha/beta/gamma/delta — exposed for tests only


def _g1_json(p):
    return ["0", "1", "0"] if p is None else [str(p[0]), str(p[1]), "1"]


def _g2_json(p):
    if p is None:
        return [["0", "0"], ["1", "0"], ["0", "0"]]
    return [[str(p[0][0]), str(p[0][1])], [str(p[1][0]), str(p[1][1])], ["1", "0"]]


def groth16_setup(
    r1cs,
    *,
    rng=None,
    toxic: dict | None = None,
    device_threshold: int = 512,
) -> SetupResult:
    """Run a 1-party Groth16 setup over an R1CS instance.

    `r1cs` is a :class:`~keyless_zk_tpu.circuits.r1cs_file.R1CS` (use
    `r1cs_from_cs` for native ConstraintSystems).  `toxic` pins the secret
    scalars for reproducible tests.
    """
    if r1cs.prime != P:
        raise ValueError("setup requires the BN254 scalar field")
    npub = r1cs.n_public
    m0 = r1cs.n_constraints
    n_vars = r1cs.n_wires

    sample = (lambda: secrets.randbelow(P - 1) + 1) if rng is None else (lambda: rng.randrange(1, P))
    tox = toxic or {}
    tau = tox.get("tau") or sample()
    alpha = tox.get("alpha") or sample()
    beta = tox.get("beta") or sample()
    gamma = tox.get("gamma") or sample()
    delta = tox.get("delta") or sample()

    # domain covers the constraints plus the nPublic+1 binding rows snarkjs
    # appends so public wires occur in A (malleability guard)
    domain_pow = max(1, (m0 + npub + 1 - 1).bit_length())
    n = 1 << domain_pow
    omega = bn254.fr_root_of_unity(domain_pow)
    eta = bn254.fr_root_of_unity(domain_pow + 1)  # eta^2 == omega, eta^n == -1

    with Span("SetupQAP"):
        # ---- Lagrange values L_q(tau) over the omega domain -------------------
        w_pows = [1] * n
        for q in range(1, n):
            w_pows[q] = w_pows[q - 1] * omega % P
        z_tau = (pow(tau, n, P) - 1) % P
        if z_tau == 0:
            raise ValueError("tau landed in the evaluation domain; resample")
        denom_inv = _batch_inv([n * (tau - wq) % P for wq in w_pows])
        lag = [z_tau * wq % P * dq % P for wq, dq in zip(w_pows, denom_inv)]

        # ---- u_i(tau), v_i(tau), w_i(tau) --------------------------------------
        # binding rows: A[m0+s][s] = 1
        rows_a = list(r1cs.A) + [{s: 1} for s in range(npub + 1)]

        def qap(rows) -> list[int]:
            acc = [0] * n_vars
            for lq, row in zip(lag, rows):
                for i, coef in row.items():
                    acc[i] += coef * lq  # reduced once at the end
            return [x % P for x in acc]

        u, v, w = qap(rows_a), qap(r1cs.B), qap(r1cs.C)

        g1, g2 = ref_curve.G1, ref_curve.G2
        gamma_inv = pow(gamma, -1, P)
        delta_inv = pow(delta, -1, P)

        ic_scalars = [
            (beta * u[i] + alpha * v[i] + w[i]) % P * gamma_inv % P for i in range(npub + 1)
        ]
        c_scalars = [
            (beta * u[i] + alpha * v[i] + w[i]) % P * delta_inv % P
            for i in range(npub + 1, n_vars)
        ]

        # ---- H basis over the eta-coset ----------------------------------------
        # L_k(tau/eta) reuses the Lagrange machinery at the shifted point.
        t2 = tau * pow(eta, -1, P) % P
        z2 = (pow(t2, n, P) - 1) % P
        if z2 == 0:
            raise ValueError("tau/eta landed in the evaluation domain; resample")
        d2_inv = _batch_inv([n * (t2 - wq) % P for wq in w_pows])
        coset_vanish = (pow(eta, n, P) - 1) % P  # == -2
        h_common = z_tau * delta_inv % P * pow(coset_vanish, -1, P) % P
        h_scalars = [z2 * wq % P * dq % P * h_common % P for wq, dq in zip(w_pows, d2_inv)]

    # ---- point tables (batched fixed-base kernels) --------------------------
    with Span("SetupPointTables"):
        tables = {
            name: _fixed_base_table(sc, group, device_threshold)
            for name, sc, group in (
                ("points_a", u, "g1"),
                ("points_b1", v, "g1"),
                ("points_b2", v, "g2"),
                ("points_c", c_scalars, "g1"),
                ("points_h", h_scalars, "g1"),
            )
        }
    pts_ic = [g1.mul(ref_curve.G1_GEN, k) for k in ic_scalars]

    vk_alpha1 = g1.mul(ref_curve.G1_GEN, alpha)
    vk_beta1 = g1.mul(ref_curve.G1_GEN, beta)
    vk_beta2 = g2.mul(ref_curve.G2_GEN, beta)
    vk_gamma2 = g2.mul(ref_curve.G2_GEN, gamma)
    vk_delta1 = g1.mul(ref_curve.G1_GEN, delta)
    vk_delta2 = g2.mul(ref_curve.G2_GEN, delta)

    with Span("SetupCoefTable"):
        # ---- coefficient table (zkey section 4 semantics) -----------------------
        def flat(rows):
            """(destination rows, wires, coefficients) of a row-major matrix."""
            lens = np.fromiter((len(r) for r in rows), np.int64, len(rows))
            dest = np.repeat(np.arange(len(rows), dtype=np.uint32), lens)
            wires = np.fromiter(
                itertools.chain.from_iterable(r.keys() for r in rows), np.uint32, int(lens.sum())
            )
            return dest, wires, list(itertools.chain.from_iterable(r.values() for r in rows))

        (ca, sa, va), (cb, sb, vb) = flat(rows_a), flat(r1cs.B)
        coef_val = _coef_limbs(va + vb)

    pk = ProvingKey(
        n8q=32,
        n8r=32,
        q=bn254.Q,
        r=P,
        n_vars=n_vars,
        n_public=npub,
        domain_size=n,
        n_coefs=len(va) + len(vb),
        vk_alpha1=vk_alpha1,
        vk_beta1=vk_beta1,
        vk_beta2=vk_beta2,
        vk_gamma2=vk_gamma2,
        vk_delta1=vk_delta1,
        vk_delta2=vk_delta2,
        coef_m=np.repeat(np.arange(2, dtype=np.uint32), [len(va), len(vb)]),
        coef_c=np.concatenate([ca, cb]),
        coef_s=np.concatenate([sa, sb]),
        coef_val=coef_val,
        **tables,
    )

    vk = {
        "protocol": "groth16",
        "curve": "bn128",
        "nPublic": npub,
        "vk_alpha_1": _g1_json(vk_alpha1),
        "vk_beta_2": _g2_json(vk_beta2),
        "vk_gamma_2": _g2_json(vk_gamma2),
        "vk_delta_2": _g2_json(vk_delta2),
        "IC": [_g1_json(p) for p in pts_ic],
    }
    return SetupResult(
        pk=pk,
        vk=vk,
        toxic={"tau": tau, "alpha": alpha, "beta": beta, "gamma": gamma, "delta": delta},
    )


def _coef_limbs(vals: list[int]) -> np.ndarray:
    """Coefficients -> (n, 16) limbs of c*R^2 mod r. Circuits repeat a few
    coefficient values millions of times, so each distinct value converts
    once and the rows are gathered."""
    ids: dict[int, int] = {}
    idx = np.fromiter((ids.setdefault(c, len(ids)) for c in vals), np.int64, len(vals))
    table = ints_to_limbs([c * R256 % P * R256 % P for c in ids])
    return table[idx] if len(vals) else table.reshape(0, 16)


def _mont_q(x: int) -> int:
    return x * R256 % bn254.Q


def _g1_table(pts) -> G1Table:
    n = len(pts)
    xs = [0 if p is None else _mont_q(p[0]) for p in pts]
    ys = [0 if p is None else _mont_q(p[1]) for p in pts]
    return G1Table(
        x=ints_to_limbs(xs),
        y=ints_to_limbs(ys),
        inf=np.asarray([p is None for p in pts], dtype=bool),
    )


def _g2_table(pts) -> G2Table:
    xs, ys = [], []
    for p in pts:
        if p is None:
            xs.append([0, 0]), ys.append([0, 0])
        else:
            xs.append([_mont_q(p[0][0]), _mont_q(p[0][1])])
            ys.append([_mont_q(p[1][0]), _mont_q(p[1][1])])
    flat_x = ints_to_limbs([c for pair in xs for c in pair]).reshape(len(pts), 2, 16)
    flat_y = ints_to_limbs([c for pair in ys for c in pair]).reshape(len(pts), 2, 16)
    return G2Table(
        x=flat_x, y=flat_y, inf=np.asarray([p is None for p in pts], dtype=bool)
    )

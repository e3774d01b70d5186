"""Device-side generation of random curve points for benches and tests.

Host generation of n random points costs n Python scalar muls (minutes at
2^20); here the whole batch is one jitted double-and-add over the generator
with per-element random scalars (254 steps of batched dbl + masked mixed
add), then one batched inversion to affine. Points are distinct with
overwhelming probability.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..curves.jacobian import JacobianCurve, G1_CURVE, G2_CURVE
from ..curves import ref_curve
from ..fields.jax_field import FR
from ..fields.limbs import LIMB_BITS, NUM_LIMBS, ints_to_limbs

SCALAR_BITS = 254


@functools.partial(jax.jit, static_argnames=("curve", "n_bits"))
def _points_from_scalars(gx, gy, scalars, *, curve: JacobianCurve, n_bits: int = SCALAR_BITS):
    n = scalars.shape[0]
    bit_idx = jnp.arange(n_bits - 1, -1, -1)
    bits = (scalars[:, bit_idx // LIMB_BITS] >> (bit_idx % LIMB_BITS)) & 1

    qx = jnp.broadcast_to(gx, (n, *gx.shape))
    qy = jnp.broadcast_to(gy, (n, *gy.shape))
    qinf = jnp.zeros((n,), bool)

    def body(i, acc):
        acc = curve.dbl(acc)
        added = curve.add_mixed(acc, qx, qy, qinf)
        return curve.select(bits[:, i] == 1, added, acc)

    acc = jax.lax.fori_loop(0, n_bits, body, curve.infinity((n,)))
    return curve.to_affine(acc)


# elements per device generation pass: chunking bounds peak memory and
# reuses one compiled chunk shape.
_GEN_CHUNK = 1 << 16


def random_points(
    n: int, seed: int = 0, curve: JacobianCurve | None = None, bits: int = SCALAR_BITS
):
    """n distinct-w.h.p. random affine points: (x, y, inf) device arrays.

    `bits` bounds the dlogs to [1, 2^bits): the ladder then runs `bits`
    steps instead of 254 — the CPU-mesh dry run uses bits=48 (distinct
    w.h.p. at its sizes, ~5x cheaper generation); benches keep full-width
    scalars."""
    curve = curve or G1_CURVE
    gen = ref_curve.G1_GEN if curve is G1_CURVE else ref_curve.G2_GEN
    gx, gy, _ = curve.encode_affine([gen])
    rng = np.random.default_rng(seed)
    mod = ((1 << bits) if bits < SCALAR_BITS else FR.p) - 1
    vals = [1 + int.from_bytes(rng.bytes(32), "little") % mod for _ in range(n)]
    if n <= _GEN_CHUNK:
        scalars = jnp.asarray(ints_to_limbs(vals))
        return _points_from_scalars(gx[0], gy[0], scalars, curve=curve, n_bits=bits)
    xs, ys, infs = [], [], []
    for s in range(0, n, _GEN_CHUNK):
        chunk = vals[s : s + _GEN_CHUNK]
        pad = _GEN_CHUNK - len(chunk)  # keep one compiled shape
        scalars = jnp.asarray(ints_to_limbs(chunk + [1] * pad))
        x, y, inf = _points_from_scalars(gx[0], gy[0], scalars, curve=curve, n_bits=bits)
        m = len(chunk)
        xs.append(np.asarray(x)[:m])
        ys.append(np.asarray(y)[:m])
        infs.append(np.asarray(inf)[:m])
    return (
        jnp.asarray(np.concatenate(xs)),
        jnp.asarray(np.concatenate(ys)),
        jnp.asarray(np.concatenate(infs)),
    )


def random_scalars(n: int, seed: int = 1) -> jnp.ndarray:
    """Uniform [0, r) scalars as (n, 16) limbs (fixes the round-1 bench's
    int64-overflow sampling skew)."""
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        ints_to_limbs([int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(n)])
    )

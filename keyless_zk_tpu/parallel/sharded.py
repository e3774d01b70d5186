"""Sharded proving kernels over a jax.sharding.Mesh.

Replacements for the reference's TBB parallelism (SURVEY §2.4):

- `sharded_msm`: points and scalars are partitioned across the mesh's
  `data` axis (the analog of multiexp.cpp's per-thread chunks); each chip
  runs the full local Pippenger, then the per-chip Jacobian partials are
  combined with one tiny all_gather + log-depth EC tree add. Communication
  is O(devices), independent of n — MSM scales linearly until the per-chip
  slice stops filling the device.
- `sharded_ntt_batch`: a batch of polynomials laid out one-per-chip (the
  batched-prover configuration; intra-proof NTT sharding comes later via a
  four-step transpose decomposition).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

shard_map = jax.shard_map

from ..curves.jacobian import JacobianCurve, JacPoint
from ..ops.msm import _msm_small, msm
from ..ops.ntt import get_plan


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, (axis,))


def _tree_add_points(curve: JacobianCurve, pts: JacPoint) -> JacPoint:
    """Log-depth reduction of a (k, ...) batch of Jacobian points."""
    from ..ops.msm import tree_reduce_points

    return tree_reduce_points(curve, pts, pts.x.shape[0])


from functools import lru_cache


@lru_cache(maxsize=64)
def _sharded_msm_fn(curve: JacobianCurve, mesh: Mesh, axis: str, coord_ndim: int, kw: tuple):
    """Build-once jitted shard_map MSM (rebuilding the closure per call
    would force a re-trace/re-compile on every invocation)."""
    msm_kwargs = dict(kw)
    coord = P(axis, *([None] * (coord_ndim - 1)))

    def local(px, py, pinf, s):
        part = msm(px, py, pinf, s, curve=curve, **msm_kwargs)
        # gather the per-chip partial sums and reduce on every chip
        gathered = jax.tree.map(lambda a: jax.lax.all_gather(a, axis), part)
        return _tree_add_points(curve, JacPoint(*gathered))

    return jax.jit(
        shard_map(
            local,
            mesh=mesh,
            in_specs=(coord, coord, P(axis), P(axis, None)),
            out_specs=JacPoint(P(), P(), P()),
            check_vma=False,
        )
    )


def sharded_msm(
    points_x: jnp.ndarray,
    points_y: jnp.ndarray,
    points_inf: jnp.ndarray,
    scalars: jnp.ndarray,
    *,
    curve: JacobianCurve,
    mesh: Mesh,
    axis: str = "data",
    **msm_kwargs,
) -> JacPoint:
    """MSM with points sharded across `axis`; result replicated.

    n must be divisible by the mesh size (pad with zero scalars upstream).
    """
    f = _sharded_msm_fn(
        curve, mesh, axis, points_x.ndim, tuple(sorted(msm_kwargs.items()))
    )
    return f(points_x, points_y, points_inf, scalars)


@partial(jax.jit, static_argnums=(1, 2))
def _twiddle_matrix(w_mont: jnp.ndarray, n1: int, n2: int) -> jnp.ndarray:
    """W[j1, k2] = w^(j1*k2), (n1, n2, 16) Montgomery.

    Log-doubling over rows: W[m+a] = W[a] * G_m where G_m[k2] = w^(m*k2)
    starts as the k2 geometric row and squares elementwise each doubling.
    """
    from ..fields import jax_field as jf
    from ..fields.jax_field import FR
    from ..ops.ntt import geometric_powers

    G = geometric_powers(w_mont, n2)  # (n2, 16): w^k2
    one = jf.encode_ints([FR.r_mod_p], FR)[0]
    W = jnp.broadcast_to(one, (1, n2, 16))
    cur = G
    while W.shape[0] < n1:
        W = jnp.concatenate([W, jf.mont_mul(W, cur[None], FR)], axis=0)
        cur = jf.mont_mul(cur, cur, FR)
    return W


def four_step_ntt(
    x: jnp.ndarray,
    *,
    domain_pow: int,
    mesh: Mesh,
    axis: str = "data",
    n1_pow: int | None = None,
    inverse: bool = False,
) -> jnp.ndarray:
    """One 2^domain_pow NTT sharded across the mesh (four-step decomposition).

    The answer to SURVEY §2.4's "Comm" row for the FFT: where the
    reference's fft.cpp parallelizes butterflies over threads in shared
    memory, a transform too big (or too batched) for one chip splits as
    n = n1*n2 with j = j1 + n1*j2, k = k2 + n2*k1:

        X[n2*k1 + k2] = NTT_n1^(j1) [ w^(j1*k2) * NTT_n2^(j2)[x[j1 + n1*j2]] ]

    Step 1 runs n1 local n2-point NTTs (sharded over j1), step 2 applies the
    twiddle matrix, step 3 is ONE all-to-all over ICI (the only
    communication: n/D elements per chip), step 4 runs n2 local n1-point
    NTTs (sharded over k2). Output is in standard order, so the Groth16
    intt -> coset mul -> ntt pipeline composes unchanged.

    x: (n, 16) Fr Montgomery. Returns (n, 16). Requires D | n1 and D | n2.
    """
    f, n1, n2 = _four_step_fn(domain_pow, n1_pow, mesh, axis, inverse)
    out2d = f(x.reshape(n2, n1, 16))  # out2d[k1, k2]
    return out2d.reshape(1 << domain_pow, 16)


@lru_cache(maxsize=32)
def _four_step_fn(domain_pow: int, n1_pow: int | None, mesh: Mesh, axis: str, inverse: bool):
    """Build-once jitted four-step transform for one (domain, mesh) shape."""
    from ..fields import bn254
    from ..fields import jax_field as jf
    from ..fields.jax_field import FR

    D = mesh.shape[axis]
    if n1_pow is None:
        n1_pow = max(domain_pow // 2, (D - 1).bit_length())
    n2_pow = domain_pow - n1_pow
    n1, n2 = 1 << n1_pow, 1 << n2_pow
    if n1 % D or n2 % D:
        raise ValueError(f"mesh size {D} must divide both n1={n1} and n2={n2}")
    plan1, plan2 = get_plan(n1_pow), get_plan(n2_pow)

    w = bn254.fr_root_of_unity(domain_pow)
    if inverse:
        w = pow(w, -1, FR.p)
    w_mont = jf.encode_ints([w], FR, mont=True)[0]
    W = _twiddle_matrix(w_mont, n1, n2)

    def local(y_l, w_l):
        # y_l: (n2, n1/D, 16) — full j2, local j1 block; w_l: (n1/D, n2, 16)
        z = jnp.moveaxis(y_l, 0, 1)  # (n1/D, n2, 16)
        z = plan2.intt(z) if inverse else plan2.ntt(z)  # j2 -> k2
        z = jf.mont_mul(z, w_l, FR)
        # reshard: full j1 on device, k2 split (the one collective)
        z = jax.lax.all_to_all(z, axis, split_axis=1, concat_axis=0, tiled=True)
        z = jnp.moveaxis(z, 0, 1)  # (n2/D, n1, 16) — local k2, full j1
        z = plan1.intt(z) if inverse else plan1.ntt(z)  # j1 -> k1
        return jnp.moveaxis(z, 0, 1)  # (n1, n2/D, 16) = out2d local block

    sm = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, axis, None), P(axis, None, None)),
        out_specs=P(None, axis, None),
        check_vma=False,
    )
    return jax.jit(lambda y: sm(y, W)), n1, n2


@lru_cache(maxsize=32)
def _ntt_batch_fn(domain_pow: int, mesh: Mesh, axis: str, inverse: bool):
    plan = get_plan(domain_pow)

    def local(x):
        return plan.intt(x) if inverse else plan.ntt(x)

    return jax.jit(
        shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis, None, None),),
            out_specs=P(axis, None, None),
            check_vma=False,
        )
    )


def sharded_ntt_batch(
    polys: jnp.ndarray, *, domain_pow: int, mesh: Mesh, axis: str = "data", inverse=False
) -> jnp.ndarray:
    """Batch-of-polynomials NTT, one batch slice per chip: (B, n, 16)."""
    return _ntt_batch_fn(domain_pow, mesh, axis, inverse)(polys)

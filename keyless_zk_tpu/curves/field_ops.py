"""Coordinate-field abstraction so one Jacobian module serves G1 and G2.

The reference instantiates its C++ Curve template for RawFq and
F2Field<RawFq> (alt_bn128.hpp:9-69); here the same role is played by two
`CoordOps` objects whose methods are batched JAX functions. Coordinates are
always in Montgomery form.

Shapes: Fq coordinate (..., 16); Fq2 coordinate (..., 2, 16).

``mul_many`` multiplies several independent operand pairs as ONE stacked
Montgomery multiply (see JacobianCurve._lockstep).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..fields import bn254
from ..fields import jax_field as jf
from ..fields.jax_field import FQ
from ..fields.limbs import int_to_limbs
from . import ref_curve


class FqOps:
    """Batched Fq operations on (..., 16) Montgomery limbs."""

    coord_ndim = 1

    def add(self, a, b):
        return jf.add(a, b, FQ)

    def sub(self, a, b):
        return jf.sub(a, b, FQ)

    def mul(self, a, b):
        return jf.mont_mul(a, b, FQ)

    def mul_many(self, pairs):
        """[a_k * b_k] for equal-shaped operands, as one stacked multiply."""
        if len(pairs) == 1:
            return [self.mul(*pairs[0])]
        out = jf.mont_mul(
            jnp.stack([a for a, _ in pairs]), jnp.stack([b for _, b in pairs]), FQ
        )
        return list(out)

    def sqr(self, a):
        return jf.mont_mul(a, a, FQ)

    def neg(self, a):
        return jf.neg(a, FQ)

    def inv(self, a):
        return jf.mont_inv(a, FQ)

    def is_zero(self, a):
        return jf.is_zero(a)

    def select(self, mask, a, b):
        """mask has batch shape; broadcast over coordinate dims."""
        return jnp.where(mask[..., None], a, b)

    def zeros(self, shape=()):
        return jnp.zeros((*shape, 16), dtype=jnp.uint32)

    def const(self, value: int, shape=()):
        """Host int -> Montgomery-form constant batch."""
        v = jnp.asarray(int_to_limbs(FQ.to_mont_int(value % FQ.p)), dtype=jnp.uint32)
        return jnp.broadcast_to(v, (*shape, 16))

    # host codecs
    def encode(self, values, mont=True):
        """List of coordinate ints -> (n, 16)."""
        return jf.encode_ints(values, FQ, mont=mont)

    def decode(self, arr, mont=True):
        return jf.decode_ints(arr, FQ, mont=mont)


class Fq2Ops:
    """Batched Fq2 = Fq[u]/(u^2+1) operations on (..., 2, 16) Montgomery limbs."""

    coord_ndim = 2

    def add(self, a, b):
        return jf.add(a, b, FQ)

    def sub(self, a, b):
        return jf.sub(a, b, FQ)

    def mul(self, a, b):
        return self.mul_many([(a, b)])[0]

    def mul_many(self, pairs):
        """[a_k * b_k] for equal-shaped operands: Karatsuba's three Fq
        products of every pair, (a0 b0, a1 b1, (a0+a1)(b0+b1)), run as one
        stacked Fq multiply."""
        a = jnp.stack([x for x, _ in pairs])
        b = jnp.stack([y for _, y in pairs])

        def karatsuba_operands(v):
            v0, v1 = v[..., 0, :], v[..., 1, :]
            return jnp.stack([v0, v1, jf.add(v0, v1, FQ)])

        t0, t1, t2 = jf.mont_mul(karatsuba_operands(a), karatsuba_operands(b), FQ)
        re = jf.sub(t0, t1, FQ)
        im = jf.sub(jf.sub(t2, t0, FQ), t1, FQ)
        return list(jnp.stack([re, im], axis=-2))

    def sqr(self, a):
        a0, a1 = a[..., 0, :], a[..., 1, :]
        re = jf.mont_mul(jf.add(a0, a1, FQ), jf.sub(a0, a1, FQ), FQ)
        t = jf.mont_mul(a0, a1, FQ)
        im = jf.add(t, t, FQ)
        return jnp.stack([re, im], axis=-2)

    def neg(self, a):
        return jnp.stack([jf.neg(a[..., 0, :], FQ), jf.neg(a[..., 1, :], FQ)], axis=-2)

    def inv(self, a):
        a0, a1 = a[..., 0, :], a[..., 1, :]
        d = jf.add(jf.mont_mul(a0, a0, FQ), jf.mont_mul(a1, a1, FQ), FQ)
        di = jf.mont_inv(d, FQ)
        return jnp.stack(
            [jf.mont_mul(a0, di, FQ), jf.neg(jf.mont_mul(a1, di, FQ), FQ)], axis=-2
        )

    def is_zero(self, a):
        return jnp.all(a == 0, axis=(-1, -2))

    def select(self, mask, a, b):
        return jnp.where(mask[..., None, None], a, b)

    def zeros(self, shape=()):
        return jnp.zeros((*shape, 2, 16), dtype=jnp.uint32)

    def const(self, value, shape=()):
        """Fq2 pair of host ints -> Montgomery constant batch."""
        c0, c1 = value if isinstance(value, tuple) else (value, 0)
        v = np.stack(
            [
                int_to_limbs(FQ.to_mont_int(c0 % FQ.p)),
                int_to_limbs(FQ.to_mont_int(c1 % FQ.p)),
            ]
        )
        return jnp.broadcast_to(jnp.asarray(v, dtype=jnp.uint32), (*shape, 2, 16))

    # host codecs
    def encode(self, values, mont=True):
        """List of (c0, c1) pairs -> (n, 2, 16)."""
        c0 = jf.encode_ints([v[0] for v in values], FQ, mont=mont)
        c1 = jf.encode_ints([v[1] for v in values], FQ, mont=mont)
        return jnp.stack([c0, c1], axis=-2)

    def decode(self, arr, mont=True):
        c0 = jf.decode_ints(arr[..., 0, :], FQ, mont=mont)
        c1 = jf.decode_ints(arr[..., 1, :], FQ, mont=mont)
        return list(zip(c0, c1))


FQ_OPS = FqOps()
FQ2_OPS = Fq2Ops()

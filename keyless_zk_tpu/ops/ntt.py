"""Number-theoretic transform over BN254 Fr as int8 matrix products.

Replaces the reference's TBB radix-2 FFT (rust-rapidsnark/rapidsnark/src/
fft.cpp:191-246) with a transform whose inner loop is an s8 x s8 -> s32
matrix product, which XLA hands to cuBLAS (the int8 tensor-core path):

- mixed-radix DIF decomposition with radix 128: n = 128^a * r_tail. Each
  pass computes a DFT_128 along one axis as a matrix product
  W (128x128) @ X (128 x batch) over Fr.
- Fr elements (16x16-bit limbs, Montgomery form) are split into 32 byte
  planes; the modular matmul becomes a 32x32 byte-plane convolution of s8
  matmuls accumulated in s32. Values are 0..255 — s8 inputs are offset by
  128 and corrected with row/column sums (A@B = A'@B' + 128*rowsum_A' +
  128*colsum_B' + 128^2*K, exact in s32).
- each output element then gets ONE lazy Montgomery reduction of the
  512-bit column accumulator (REDC), instead of one reduction per product
  as in a butterfly form: 128 products amortize one REDC.
- inter-pass twiddles w_n^(q*t) are precomputed Montgomery tables applied
  with the elementwise mont_mul; the final digit-reverse gather gives the
  reference's convention: ``ntt(x)[k] = sum_j x[j] w^(jk)`` with
  w = nqr^((r-1)/2^s) (bn254.py); ``intt`` uses w^-1 and scales by n^-1;
  the Groth16 coset shift multiplies by powers of the 2^(s+1)-th root
  (groth16.cpp:182-190).

All values are Fr in Montgomery form, shape (..., n, 16) uint32. On an
H100 at 2^21 x 3 this form took 0.16 s per transform against 0.68 s for
the 21-level butterfly form (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..fields import bn254
from ..fields.jax_field import FR
from ..fields import jax_field as jf


def geometric_powers(base_mont: jnp.ndarray, n: int) -> jnp.ndarray:
    """[1, g, g^2, ..., g^(n-1)] in Montgomery form, built by log-doubling."""
    assert n & (n - 1) == 0
    pows = jf.encode_ints([FR.r_mod_p], FR)  # [R] = mont(1), shape (1, 16)
    base = base_mont.reshape(1, 16)
    cur = base  # g^(len(pows))
    while pows.shape[0] < n:
        pows = jnp.concatenate([pows, jf.mont_mul(pows, cur, FR)], axis=0)
        cur = jf.mont_mul(cur, cur, FR)
    return pows


def host_ntt(vals: list[int], w: int) -> list[int]:
    """Plain reference: recursive radix-2 NTT over host ints,
    out[k] = sum_j vals[j] w^(jk) mod r (O(n log n))."""
    p = FR.p
    n = len(vals)
    if n == 1:
        return vals[:]
    even = host_ntt(vals[0::2], w * w % p)
    odd = host_ntt(vals[1::2], w * w % p)
    out = [0] * n
    wk = 1
    for k in range(n // 2):
        t = wk * odd[k] % p
        out[k] = (even[k] + t) % p
        out[k + n // 2] = (even[k] - t) % p
        wk = wk * w % p
    return out


NB = 32  # byte planes per 256-bit element

# The accumulated T = sum_s W[q,s]*x[s] is bounded by r*p^2 < 2^515 for
# r = 128 — ABOVE the classic REDC bound p*R (R = 2^256). We therefore
# reduce by 2^320 instead (result < 2^(515-320) + p < 2p) and pre-scale the
# DFT matrix entries by 2^64 so the Montgomery form survives:
#   sum (w*R*2^64)(x*R) * 2^-320 = (sum w*x) * R.
RED_BITS = 320
RED_BYTES = RED_BITS // 8  # 40
T_BYTES = 66  # ceil(515/8) + carry margin

P_INT = FR.p
MU = (-pow(P_INT, -1, 1 << RED_BITS)) % (1 << RED_BITS)  # -p^-1 mod 2^320
SCALE = (1 << 64) % P_INT
P_BYTES = [(P_INT >> (8 * i)) & 0xFF for i in range(32)]
MU_BYTES = [(MU >> (8 * i)) & 0xFF for i in range(RED_BYTES)]


def factorize(n: int) -> list[int]:
    """n = prod(factors), greedy radix-128 then the power-of-two tail."""
    fs = []
    while n >= 128:
        fs.append(128)
        n //= 128
    if n > 1:
        fs.append(n)
    return fs


def digit_reverse_perm(factors: list[int]) -> np.ndarray:
    """Output index permutation for the DIF pass chain: pass q-digits are
    stored big-endian but the true frequency index reads them little-endian."""
    n = int(np.prod(factors))
    idx = np.arange(n)
    digits = []
    rest = idx
    block = n
    for f in factors:  # storage digits, most-significant first
        block //= f
        digits.append(rest // block)
        rest = rest % block
    # storage (q0, q1, ..., qk) -> true index q0 + r0*(q1 + r1*(...))
    true = np.zeros_like(idx)
    mult = 1
    for f, d in zip(factors, digits):
        true = true + d * mult
        mult *= f
    out = np.zeros_like(idx)
    out[true] = idx
    return out


def _dft_matrix_mont(r: int, w_r: int) -> np.ndarray:
    """(r, r, 16) u32: W[q, s] = mont(w_r^(q*s)) * 2^64 (see RED_BITS)."""
    rows = []
    for q in range(r):
        vals = [
            pow(w_r, q * s, P_INT) * FR.r_mod_p % P_INT * SCALE % P_INT
            for s in range(r)
        ]
        rows.append(vals)
    flat = np.array(rows, dtype=object).reshape(-1)
    out = np.zeros((r * r, 16), dtype=np.uint32)
    for i, v in enumerate(flat):
        for limb in range(16):
            out[i, limb] = (int(v) >> (16 * limb)) & 0xFFFF
    return out.reshape(r, r, 16)


def _to_byte_planes(x: jnp.ndarray) -> jnp.ndarray:
    """(..., 16) u32 16-bit limbs -> (..., 32) s32 byte values 0..255."""
    lo = x & 0xFF
    hi = (x >> 8) & 0xFF
    return jnp.stack([lo, hi], axis=-1).reshape(*x.shape[:-1], NB).astype(jnp.int32)


_CHUNK = 4096  # batch elements per matmul chunk (bounds the s32 output block)


def _dft_mod_chunk(w_big, w_rowsum, x: jnp.ndarray) -> jnp.ndarray:
    """DFT_r over one batch chunk: x (cb, r, 16) u32 mont -> (cb, r, 16).

    ONE block matmul per chunk: the 32x32 byte-plane convolution is folded
    into the contraction via the banded matrix W_BIG[k*r+q, j*r+s] =
    byte_{k-j}(W[q,s]) — output row (k, q) directly holds byte column k of
    T_q, contraction K = 32*r. s32 accumulation is exact: each output sums
    <= 32*r byte products (< 2^28 for r = 128)."""
    cb, r, _ = x.shape
    xb = _to_byte_planes(x)  # (cb, r, 32) values 0..255
    xb = jnp.transpose(xb, (2, 1, 0)).reshape(NB * r, cb)  # row (j*r + s)
    xb8 = (xb - 128).astype(jnp.int8)
    colsum = jnp.sum(xb, axis=0, dtype=jnp.int32)  # (cb,)

    d = jax.lax.dot_general(
        w_big, xb8, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32
    )  # (63*r, cb)
    # undo offsets (A = A'+128, B = B'+128): AB = A'B' + 128*rowsum_A'
    # + 128*colsum_B (the two 128^2*K terms cancel)
    wide = d + 128 * (w_rowsum[:, None] + colsum[None, :])

    wide = jnp.moveaxis(wide.reshape(2 * NB - 1, r, cb), 0, 2)
    out = redc_columns(wide.reshape(r * cb, 2 * NB - 1))
    return jnp.moveaxis(out.reshape(r, cb, 16), 0, 1)  # (cb, r, 16)


def _dft_mod(w_planes, w_rowsum, x: jnp.ndarray) -> jnp.ndarray:
    """DFT_r along axis -2 of x ((..., r, 16) u32 mont) via byte-plane
    matmuls + one lazy REDC per output element. Returns (..., r, 16).

    The batch runs in _CHUNK-sized slices under lax.map so the (32, r,
    cb*32) s32 plane tensor stays bounded (~260 MB at cb=512, r=128) —
    the monolithic form would need r*m*32*32*4 bytes (8.6 GB at 2^21)."""
    r = x.shape[-2]
    batch = x.shape[:-2]
    m = int(np.prod(batch)) if batch else 1
    xf = x.reshape(m, r, 16)
    if m <= _CHUNK:
        out = _dft_mod_chunk(w_planes, w_rowsum, xf)
        return out.reshape(*batch, r, 16)
    nc = -(-m // _CHUNK)
    pad = nc * _CHUNK - m
    if pad:
        xf = jnp.concatenate([xf, jnp.zeros((pad, r, 16), xf.dtype)])
    out = jax.lax.map(
        lambda c: _dft_mod_chunk(w_planes, w_rowsum, c),
        xf.reshape(nc, _CHUNK, r, 16),
    ).reshape(nc * _CHUNK, r, 16)
    if pad:
        out = out[:m]
    return out.reshape(*batch, r, 16)


def redc_columns(wide: jnp.ndarray) -> jnp.ndarray:
    """Lazy Montgomery reduction: (N, 63) s32 byte-weighted columns of
    T < 2^515 -> (N, 16) u32 canonical mont limbs (T * 2^-320 mod p).

    Straight-line integer code that XLA fuses into elementwise kernels.
    """
    n = wide.shape[0]
    w = wide.astype(jnp.uint32)

    # 1. resolve to canonical bytes t_b of T (T < 2^515 -> 65 bytes)
    tb = []
    carry = jnp.zeros((n,), jnp.uint32)
    for k in range(T_BYTES):
        v = (w[:, k] if k < wide.shape[1] else 0) + carry
        tb.append(v & 0xFF)
        carry = v >> 8
    # 2. m = (T mod 2^320) * mu mod 2^320 (byte conv, low 40 cols)
    mcols = [jnp.zeros((n,), jnp.uint32) for _ in range(RED_BYTES)]
    for i in range(RED_BYTES):
        for j in range(RED_BYTES - i):
            if MU_BYTES[j]:
                mcols[i + j] = mcols[i + j] + tb[i] * MU_BYTES[j]
    mb = []
    carry = jnp.zeros((n,), jnp.uint32)
    for k in range(RED_BYTES):
        v = mcols[k] + carry
        mb.append(v & 0xFF)
        carry = v >> 8
    # 3. S = T + m*p; S mod 2^320 == 0; result = S >> 320 < 2p
    n_s = max(T_BYTES, RED_BYTES + NB) + 1
    scols = [
        tb[k] if k < T_BYTES else jnp.zeros((n,), jnp.uint32)
        for k in range(n_s)
    ]
    for i in range(RED_BYTES):
        for j in range(NB):
            if P_BYTES[j]:
                scols[i + j] = scols[i + j] + mb[i] * P_BYTES[j]
    carry = jnp.zeros((n,), jnp.uint32)
    for k in range(RED_BYTES):  # low 40 byte columns vanish into the carry
        carry = (scols[k] + carry) >> 8
    res = []
    for k in range(RED_BYTES, RED_BYTES + NB):
        v = scols[k] + carry
        res.append(v & 0xFF)
        carry = v >> 8
    # res: 32 bytes (result < 2p < 2^255). combine to 16-bit limbs
    limbs = [res[2 * t] | (res[2 * t + 1] << 8) for t in range(16)]
    x = jnp.stack(limbs, axis=-1)
    # conditional subtract p (result < 2p guaranteed by the 2^320 REDC)
    return jf._csub_p(x, FR)


@functools.partial(jax.jit, static_argnames="factors")
def _transform_jit(x, perm, factors, tables):
    """Mixed-radix DIF pass chain + digit-reverse gather."""
    batch = x.shape[:-2]
    n = x.shape[-2]
    b = 1
    m_rest = n
    for (w_planes, w_rowsum, tw), r in zip(tables, factors):
        m = m_rest // r
        v = x.reshape(*batch, b, r, m, 16)
        v = jnp.moveaxis(v, -2, -3)  # (..., b, m, r, 16): DFT axis last-ish
        g = _dft_mod(w_planes, w_rowsum, v.reshape(-1, r, 16))
        g = g.reshape(*batch, b, m, r, 16)
        g = jnp.moveaxis(g, -2, -3)  # back to (..., b, r, m, 16)
        if tw is not None:
            g = jf.mont_mul(g, tw, FR)  # broadcast (r, m, 16)
        x = g.reshape(*batch, n, 16)
        b *= r
        m_rest = m
    return jnp.take(x, perm, axis=-2)


class NTTPlan:
    """Precomputed matmul-pass tables for one 2^domain_pow domain
    (device-resident); the analog of the reference precomputing its root
    table once in the FFT ctor (fft.cpp:39-136)."""

    def __init__(self, domain_pow: int):
        if domain_pow > bn254.TWO_ADICITY:
            raise ValueError("domain size too big for the curve")  # fft.cpp:80-83
        self.domain_pow = domain_pow
        self.n = 1 << domain_pow
        self.factors = factorize(self.n)
        w = bn254.fr_root_of_unity(domain_pow)
        self.n_inv_mont = jf.encode_ints([pow(self.n, -1, P_INT)], FR, mont=True)[0]
        self.perm = jnp.asarray(digit_reverse_perm(self.factors))
        self._coset = None
        self.tables = self._build(w)
        self.tables_inv = self._build(pow(w, -1, P_INT))

    def _build(self, w: int):
        """Per pass: (W byte planes s8, W plane rowsums, twiddle (r, m, 16))."""
        n = self.n
        passes = []
        m_rest = n
        for r in self.factors:
            m = m_rest // r
            w_block = pow(w, n // m_rest, P_INT)  # primitive (r*m)-th root
            w_r = pow(w_block, m, P_INT)  # primitive r-th root
            wmat = _dft_matrix_mont(r, w_r)  # (r, r, 16) u32
            wb = np.zeros((NB, r, r), dtype=np.int16)
            for limb in range(16):
                wb[2 * limb] = wmat[:, :, limb] & 0xFF
                wb[2 * limb + 1] = wmat[:, :, limb] >> 8
            # banded block matrix: W_BIG[k*r+q, j*r+s] = byte_{k-j}(W[q,s])
            wbig = np.zeros((2 * NB - 1, r, NB, r), dtype=np.int16)
            for k in range(2 * NB - 1):
                for j in range(max(0, k - NB + 1), min(NB, k + 1)):
                    wbig[k, :, j, :] = wb[k - j]
            wbig = wbig.reshape((2 * NB - 1) * r, NB * r)
            w_big = jnp.asarray((wbig - 128).astype(np.int8))
            w_rowsum = jnp.asarray(
                (wbig.astype(np.int64) - 128).sum(axis=1).astype(np.int32)
            )
            # twiddle w_block^(q*t), q < r, t < m (mont form), on device
            if m > 1:
                base = geometric_powers(
                    jf.encode_ints([w_block], FR, mont=True)[0], m
                )  # base[t] = mont(w_block^t)
                rows = [jf.encode_ints([1] * m, FR, mont=True)]  # q=0
                cur = base
                for q in range(1, r):
                    rows.append(cur)
                    cur = jf.mont_mul(cur, base, FR)
                tw = jnp.stack(rows)  # (r, m, 16)
            else:
                tw = None
            passes.append((w_big, w_rowsum, tw))
            m_rest = m
        return passes

    def _transform(self, x: jnp.ndarray, tables) -> jnp.ndarray:
        # tables/perm ride as jitted-function ARGUMENTS (not closed-over
        # constants): the pass-1 twiddle alone is 128 MB at 2^21.
        return _transform_jit(x, self.perm, tuple(self.factors), tuple(tables))

    def ntt(self, x: jnp.ndarray) -> jnp.ndarray:
        return self._transform(x, self.tables)

    def intt(self, x: jnp.ndarray) -> jnp.ndarray:
        y = self._transform(x, self.tables_inv)
        return jf.mont_mul(y, self.n_inv_mont, FR)

    def coset_powers(self) -> jnp.ndarray:
        """eta^i for i < n with eta the 2^(domain_pow+1)-th root of unity:
        the shift the reference applies between iFFT and FFT
        (groth16.cpp:182-190, root(domainPow+1, i)). Memoized."""
        if self._coset is None:
            eta = bn254.fr_root_of_unity(self.domain_pow + 1)
            base = jf.encode_ints([eta], FR, mont=True)[0]
            self._coset = geometric_powers(base, self.n)
        return self._coset


@functools.lru_cache(maxsize=4)
def get_plan(domain_pow: int) -> NTTPlan:
    return NTTPlan(domain_pow)

"""Groth16 proving-key (.zkey) parser -> host numpy tables.

Layout per the reference's reader (rust-rapidsnark/rapidsnark/src/
zkey_utils.hpp:48-88 and fullprover.cpp:164-174):

  section 1: u32 protocol (1 = groth16)
  section 2: n8q, q, n8r, r, nVars, nPublic, domainSize,
             vk_alpha1 (G1), vk_beta1 (G1), vk_beta2 (G2),
             vk_gamma2 (G2), vk_delta1 (G1), vk_delta2 (G2)
  section 4: u32 nCoefs, then nCoefs x { u32 m, u32 c, u32 s, Fr coef }
  section 5: pointsA   (nVars G1)
  section 6: pointsB1  (nVars G1)
  section 7: pointsB2  (nVars G2)
  section 8: pointsC   (nVars - nPublic - 1 G1)
  section 9: pointsH   (domainSize G1)

Field elements are 32-byte little-endian **Montgomery-form** integers
(R = 2^256), which is byte-compatible with our device limb encoding
(fields/limbs.py), so point tables upload with zero bigint work.
G1 affine = (x, y); G2 affine = (x0, x1, y0, y1); the point at infinity is
stored as all-zero coordinates.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..fields.limbs import bytes_le_to_limbs
from .binfile import BinFile, le_bytes_to_int


@dataclass
class G1Table:
    """(n, 16) uint32 Montgomery limb arrays + infinity mask (host numpy)."""

    x: np.ndarray
    y: np.ndarray
    inf: np.ndarray


@dataclass
class G2Table:
    """(n, 2, 16) uint32 Montgomery limb arrays + infinity mask."""

    x: np.ndarray
    y: np.ndarray
    inf: np.ndarray


def _parse_g1_table(buf: np.ndarray, n8q: int) -> G1Table:
    rec = 2 * n8q
    n = buf.size // rec
    limbs = bytes_le_to_limbs(buf[: n * rec], n8q).reshape(n, 2, 16)
    x, y = limbs[:, 0], limbs[:, 1]
    inf = ~(np.any(x != 0, axis=-1) | np.any(y != 0, axis=-1))
    return G1Table(x=x, y=y, inf=inf)


def _parse_g2_table(buf: np.ndarray, n8q: int) -> G2Table:
    rec = 4 * n8q
    n = buf.size // rec
    limbs = bytes_le_to_limbs(buf[: n * rec], n8q).reshape(n, 4, 16)
    x = limbs[:, 0:2]  # (n, 2, 16): c0, c1
    y = limbs[:, 2:4]
    inf = ~(np.any(x != 0, axis=(-1, -2)) | np.any(y != 0, axis=(-1, -2)))
    return G2Table(x=x, y=y, inf=inf)


@dataclass
class ProvingKey:
    n8q: int
    n8r: int
    q: int
    r: int
    n_vars: int
    n_public: int
    domain_size: int
    n_coefs: int
    # vk points as standard-form host ints (converted out of Montgomery)
    vk_alpha1: tuple
    vk_beta1: tuple
    vk_beta2: tuple
    vk_gamma2: tuple
    vk_delta1: tuple
    vk_delta2: tuple
    # coefficient table (section 4)
    coef_m: np.ndarray  # (nCoefs,) uint32, 0 -> a, 1 -> b
    coef_c: np.ndarray  # (nCoefs,) uint32 destination index in the domain
    coef_s: np.ndarray  # (nCoefs,) uint32 source witness index
    coef_val: np.ndarray  # (nCoefs, 16) uint32, raw Montgomery-form limbs
    # point tables (Montgomery limb form, ready for device upload)
    points_a: G1Table
    points_b1: G1Table
    points_b2: G2Table
    points_c: G1Table
    points_h: G1Table
    # IC points (section 3): n_public+1 G1 points, standard-form host ints —
    # with these the snarkjs VK is fully recoverable from the zkey alone
    vk_ic: tuple = ()


def _g1_std(buf: np.ndarray, n8q: int, q: int) -> tuple:
    """One stored G1 point -> standard-form (x, y) ints (or None for inf)."""
    r_inv = pow(1 << (8 * n8q), -1, q)
    x = le_bytes_to_int(buf[:n8q]) * r_inv % q
    y = le_bytes_to_int(buf[n8q : 2 * n8q]) * r_inv % q
    return None if x == 0 and y == 0 else (x, y)


def _g2_std(buf: np.ndarray, n8q: int, q: int) -> tuple:
    r_inv = pow(1 << (8 * n8q), -1, q)
    c = [le_bytes_to_int(buf[i * n8q : (i + 1) * n8q]) * r_inv % q for i in range(4)]
    return ((c[0], c[1]), (c[2], c[3]))


def _write_section(f, s_type: int, payload: bytes) -> None:
    f.write(struct.pack("<IQ", s_type, len(payload)))
    f.write(payload)


def _g1_bytes(table: G1Table) -> bytes:
    """Montgomery limb table -> packed 64-byte affine records (0s = inf)."""
    from ..fields.limbs import limbs_to_bytes_le

    n = table.x.shape[0]
    xs = np.frombuffer(limbs_to_bytes_le(table.x), np.uint8).reshape(n, 32)
    ys = np.frombuffer(limbs_to_bytes_le(table.y), np.uint8).reshape(n, 32)
    rec = np.concatenate([xs, ys], axis=1).copy()
    rec[np.asarray(table.inf, bool)] = 0
    return rec.tobytes()


def _g2_bytes(table: G2Table) -> bytes:
    from ..fields.limbs import limbs_to_bytes_le

    n = table.x.shape[0]
    xs = np.frombuffer(
        limbs_to_bytes_le(table.x.reshape(2 * n, 16)), np.uint8
    ).reshape(n, 64)
    ys = np.frombuffer(
        limbs_to_bytes_le(table.y.reshape(2 * n, 16)), np.uint8
    ).reshape(n, 64)
    rec = np.concatenate([xs, ys], axis=1).copy()
    rec[np.asarray(table.inf, bool)] = 0
    return rec.tobytes()


def save_zkey(path: str, pk: ProvingKey) -> None:
    """Write a snarkjs-format .zkey (inverse of load_zkey).

    Makes native setups interoperable with snarkjs/rapidsnark tooling and
    exercises the same container the reference mmaps (zkey_utils.hpp:13-90).
    """
    from ..fields.limbs import limbs_to_bytes_le

    q, r = pk.q, pk.r
    r_mont = lambda v: ((v << 256) % q).to_bytes(pk.n8q, "little")  # noqa: E731

    def g1_point(pt) -> bytes:
        if pt is None:
            return bytes(2 * pk.n8q)
        return r_mont(pt[0]) + r_mont(pt[1])

    def g2_point(pt) -> bytes:
        if pt is None:
            return bytes(4 * pk.n8q)
        return r_mont(pt[0][0]) + r_mont(pt[0][1]) + r_mont(pt[1][0]) + r_mont(pt[1][1])

    s2 = struct.pack("<I", pk.n8q) + q.to_bytes(pk.n8q, "little")
    s2 += struct.pack("<I", pk.n8r) + r.to_bytes(pk.n8r, "little")
    s2 += struct.pack("<III", pk.n_vars, pk.n_public, pk.domain_size)
    s2 += g1_point(pk.vk_alpha1) + g1_point(pk.vk_beta1) + g2_point(pk.vk_beta2)
    s2 += g2_point(pk.vk_gamma2) + g1_point(pk.vk_delta1) + g2_point(pk.vk_delta2)

    n = pk.n_coefs
    rec = np.empty((n, 12 + 32), np.uint8)
    rec[:, :12] = (
        np.stack([pk.coef_m, pk.coef_c, pk.coef_s], axis=1)
        .astype("<u4").view(np.uint8).reshape(n, 12)
    )
    rec[:, 12:] = np.frombuffer(limbs_to_bytes_le(pk.coef_val), np.uint8).reshape(n, 32)
    s4 = struct.pack("<I", n) + rec.tobytes()

    with open(path, "wb") as f:
        f.write(b"zkey")
        f.write(struct.pack("<II", 1, 9))
        _write_section(f, 1, struct.pack("<I", 1))
        _write_section(f, 2, s2)
        # section 3: IC points (snarkjs layout) — lets a VK be recovered
        # from the zkey alone (empty when the setup kept the VK separate)
        _write_section(f, 3, b"".join(g1_point(p) for p in pk.vk_ic))
        _write_section(f, 4, s4)
        _write_section(f, 5, _g1_bytes(pk.points_a))
        _write_section(f, 6, _g1_bytes(pk.points_b1))
        _write_section(f, 7, _g2_bytes(pk.points_b2))
        _write_section(f, 8, _g1_bytes(pk.points_c))
        _write_section(f, 9, _g1_bytes(pk.points_h))


def zkey_table_cache_path(path: str) -> str:
    """Where load_zkey caches the limb-format tables for a given zkey.

    Beside the zkey when it lives in a directory we own (the setup store,
    or a dir opted in via KEYLESS_ZKEY_CACHE_BESIDE) — setup-store entries
    stay self-contained with a `<name>.zkey.tables.npz`. Every other input
    path (vendored fixtures, mounted setup images, read-only media) caches
    under ``~/.cache/keyless_zk_tpu/zkey_tables/`` keyed by absolute path,
    so foreign input directories are never written to.
    """
    import hashlib
    import os

    apath = os.path.abspath(path)
    own_roots = [
        os.path.join(os.path.expanduser("~"), ".local", "share", "keyless_zk_tpu"),
    ]
    extra = os.environ.get("KEYLESS_ZKEY_CACHE_BESIDE")
    if extra:
        own_roots += [os.path.abspath(p) for p in extra.split(":") if p]
    if any(apath.startswith(r.rstrip("/") + "/") for r in own_roots):
        return path + ".tables.npz"
    key = hashlib.sha256(apath.encode()).hexdigest()[:24]
    root = os.path.join(
        os.path.expanduser("~"), ".cache", "keyless_zk_tpu", "zkey_tables"
    )
    os.makedirs(root, exist_ok=True)
    return os.path.join(root, key + ".tables.npz")


def load_zkey(
    path: str, cache: bool | None = None, cache_path: str | None = None
) -> ProvingKey:
    """Parse a snarkjs zkey; limb-format table cache (device-ready).

    The reference mmaps the zkey and converts per startup
    (fullprover.cpp:164-174); at production scale (~multi-GB, 5 point
    tables) the byte->limb conversion dominates service start, so the
    converted arrays are cached (at ``cache_path`` if given, else see
    :func:`zkey_table_cache_path`), keyed by the zkey's (size, mtime), and
    reloaded zero-copy (the analog of the setup cache in
    scripts/python/setups/cache.py, but in device format).
    Set cache=False or KEYLESS_ZKEY_CACHE=0 to disable.
    """
    import os

    if cache is None:
        cache = os.environ.get("KEYLESS_ZKEY_CACHE", "1") != "0"
    npz_path = cache_path or zkey_table_cache_path(path)
    st = os.stat(path)
    cache_key = f"{st.st_size}:{int(st.st_mtime)}"
    if cache and os.path.exists(npz_path):
        try:
            z = np.load(npz_path, allow_pickle=False)
            if str(z["cache_key"]) == cache_key:
                return _pk_from_npz(z)
        except Exception:
            pass  # stale/corrupt cache: fall through to a fresh parse
    pk = _load_zkey_uncached(path)
    if cache:
        try:
            np.savez(npz_path + ".tmp.npz", cache_key=cache_key, **_pk_to_arrays(pk))
            os.replace(npz_path + ".tmp.npz", npz_path)
        except Exception:
            pass  # read-only directory etc.: caching is best-effort
    return pk


_INT_FIELDS = ("n8q", "n8r", "n_vars", "n_public", "domain_size", "n_coefs")
_VK_FIELDS = (
    "vk_alpha1",
    "vk_beta1",
    "vk_beta2",
    "vk_gamma2",
    "vk_delta1",
    "vk_delta2",
    "vk_ic",
)
_G1_TABLES = ("points_a", "points_b1", "points_c", "points_h")


def _pk_to_arrays(pk: ProvingKey) -> dict:
    import json

    meta = {f: getattr(pk, f) for f in _INT_FIELDS}
    meta["q"] = str(pk.q)
    meta["r"] = str(pk.r)
    for f in _VK_FIELDS:
        meta[f] = json.dumps(getattr(pk, f), default=str)
    out = {"meta": np.frombuffer(json.dumps(meta, default=str).encode(), dtype=np.uint8)}
    for f in ("coef_m", "coef_c", "coef_s", "coef_val"):
        out[f] = getattr(pk, f)
    for f in _G1_TABLES + ("points_b2",):
        t = getattr(pk, f)
        out[f + "_x"], out[f + "_y"], out[f + "_inf"] = t.x, t.y, t.inf
    return out


def _int_tree(v):
    if isinstance(v, list):
        return tuple(_int_tree(x) for x in v)
    return int(v)


def _pk_from_npz(z) -> ProvingKey:
    import json

    meta = json.loads(bytes(z["meta"]).decode())
    tabs = {}
    for f in _G1_TABLES:
        tabs[f] = G1Table(z[f + "_x"], z[f + "_y"], z[f + "_inf"])
    tabs["points_b2"] = G2Table(
        z["points_b2_x"], z["points_b2_y"], z["points_b2_inf"]
    )
    return ProvingKey(
        q=int(meta["q"]),
        r=int(meta["r"]),
        **{f: int(meta[f]) for f in _INT_FIELDS},
        **{f: _int_tree(json.loads(meta[f])) for f in _VK_FIELDS},
        coef_m=z["coef_m"],
        coef_c=z["coef_c"],
        coef_s=z["coef_s"],
        coef_val=z["coef_val"],
        **tabs,
    )


def _load_zkey_uncached(path: str) -> ProvingKey:
    bf = BinFile.load(path, "zkey")
    (protocol,) = struct.unpack_from("<I", bf.section(1), 0)
    if protocol != 1:
        raise ValueError("zkey file is not groth16")  # zkey_utils.hpp:55-58

    s2 = bf.section(2)
    pos = 0
    (n8q,) = struct.unpack_from("<I", s2, pos)
    pos += 4
    q = le_bytes_to_int(s2[pos : pos + n8q])
    pos += n8q
    (n8r,) = struct.unpack_from("<I", s2, pos)
    pos += 4
    r = le_bytes_to_int(s2[pos : pos + n8r])
    pos += n8r
    n_vars, n_public, domain_size = struct.unpack_from("<III", s2, pos)
    pos += 12
    vk_alpha1 = _g1_std(s2[pos:], n8q, q)
    pos += 2 * n8q
    vk_beta1 = _g1_std(s2[pos:], n8q, q)
    pos += 2 * n8q
    vk_beta2 = _g2_std(s2[pos:], n8q, q)
    pos += 4 * n8q
    vk_gamma2 = _g2_std(s2[pos:], n8q, q)
    pos += 4 * n8q
    vk_delta1 = _g1_std(s2[pos:], n8q, q)
    pos += 2 * n8q
    vk_delta2 = _g2_std(s2[pos:], n8q, q)
    pos += 4 * n8q

    # section 4: leading u32 count, then packed 12+n8r records
    # (reference skips the count by offsetting +4: groth16.cpp:32)
    s4 = bf.section(4)
    rec = 12 + n8r
    n_coefs = (s4.size - 4) // rec
    body = s4[4 : 4 + n_coefs * rec].reshape(n_coefs, rec)
    meta = np.ascontiguousarray(body[:, :12]).view(np.uint32).reshape(n_coefs, 3)
    coef_val = bytes_le_to_limbs(np.ascontiguousarray(body[:, 12:]).reshape(-1), n8r)

    return ProvingKey(
        n8q=n8q,
        n8r=n8r,
        q=q,
        r=r,
        n_vars=n_vars,
        n_public=n_public,
        domain_size=domain_size,
        n_coefs=n_coefs,
        vk_alpha1=vk_alpha1,
        vk_beta1=vk_beta1,
        vk_beta2=vk_beta2,
        vk_gamma2=vk_gamma2,
        vk_delta1=vk_delta1,
        vk_delta2=vk_delta2,
        coef_m=meta[:, 0].copy(),
        coef_c=meta[:, 1].copy(),
        coef_s=meta[:, 2].copy(),
        coef_val=coef_val,
        points_a=_parse_g1_table(bf.section(5), n8q),
        points_b1=_parse_g1_table(bf.section(6), n8q),
        points_b2=_parse_g2_table(bf.section(7), n8q),
        points_c=_parse_g1_table(bf.section(8), n8q),
        points_h=_parse_g1_table(bf.section(9), n8q),
        vk_ic=tuple(
            _g1_std(bf.section(3)[i * 2 * n8q :], n8q, q)
            for i in range(bf.section(3).size // (2 * n8q))
        ),
    )

"""Per-gadget constraint-count tracking.

Mirror of the reference's JS constraint benchmarks (circuit/benches/
strings/*.js count AssertIsConcatenation + one SHA2 compression at --O2;
the full-circuit totals are pinned in circuit/README.md:77-82).  Pinning
each major gadget's R1CS size localizes regressions: a circuit edit that
changes a count shows up here naming the gadget, not as an opaque delta in
the 1.4M-constraint full-circuit total (tests/test_full_scale_circuit.py).

The counts are properties of OUR gadget formulations (a fresh
R1CS lowering), so the pinned values are this repo's, not circom's; the
reference's two published numbers give the scale anchor
(AssertIsConcatenation at the JWT size: 40,458 @ --O2, keyless.circom:123).
"""

import pytest

from keyless_zk_tpu.circuits import ConstraintSystem
from keyless_zk_tpu.circuits import base64_gadget as b64
from keyless_zk_tpu.circuits import hash_gadget as hg
from keyless_zk_tpu.circuits import jwt_gadget as jg
from keyless_zk_tpu.circuits import rsa_gadget as rsa
from keyless_zk_tpu.circuits import sha256_gadget as sha


def _wires(cs, n):
    return [cs.lc(w) for w in cs.new_wires(n)]


def _count(build):
    cs = ConstraintSystem()
    build(cs)
    return len(cs.constraints), cs.n_wires


def _sha_one_block(cs):
    bits = _wires(cs, 512)
    sha.sha256_prepadded(cs, bits, cs.const(0), max_blocks=1)


def _sha_jwt_blocks(cs):
    # the keyless circuit's SHA configuration: 1536 payload bytes = 24 blocks
    bits = _wires(cs, 24 * 512)
    sha.sha256_prepadded(cs, bits, cs.const(23), max_blocks=24)


def _fp_mul(cs):
    a = [rsa.materialize(cs, v) for v in _wires(cs, 32)]
    b = [rsa.materialize(cs, v) for v in _wires(cs, 32)]
    m = [rsa.materialize(cs, v) for v in _wires(cs, 32)]
    rsa.fp_mul(cs, a, b, m)


def _rsa_verify(cs):
    sig = [rsa.materialize(cs, v) for v in _wires(cs, 32)]
    mod = [rsa.materialize(cs, v) for v in _wires(cs, 32)]
    hashed = _wires(cs, 4)  # four 64-bit digest limbs
    rsa.rsa_pkcs1_verify(cs, sig, mod, hashed)


def _base64_decode_jwt(cs):
    # payload max length from the keyless config: 192*8 b64 chars
    chars = _wires(cs, 192 * 8)
    b64.base64url_decode(cs, chars, n_out=192 * 8 // 4 * 3)


def _concat_jwt(cs):
    # the reference's benched shape: full JWT split into header '.' payload
    # (AssertIsConcatenation at 192*8, keyless.circom:123-124)
    n = 192 * 8
    full, left, right = _wires(cs, n), _wires(cs, n), _wires(cs, n)
    ll = cs.lc(cs.new_wire())
    rl = cs.lc(cs.new_wire())
    hg.assert_is_concatenation(cs, full, left, right, ll, rl)


def _substring_100_in_1536(cs):
    string = _wires(cs, 1536)
    substr = _wires(cs, 100)
    hg.assert_is_substring(
        cs, string, _wires(cs, 1)[0], substr, cs.lc(cs.new_wire()), cs.lc(cs.new_wire())
    )


def _string_bodies_1536(cs):
    jg.string_bodies(cs, _wires(cs, 1536))


# gadget -> (constraints, wires); update deliberately when a formulation
# changes, with the delta called out in the commit message.
PINNED = {
    "sha256_one_block": (_sha_one_block, 26587, 26914),
    "sha256_prepadded_24_blocks": (_sha_jwt_blocks, 640066, 647937),
    "rsa_fp_mul_2048": (_fp_mul, 8875, 8909),
    "rsa_pkcs1_verify_2048": (_rsa_verify, 150907, 149873),
    "base64url_decode_1536": (_base64_decode_jwt, 135168, 124417),
    "concatenation_jwt_1536": (_concat_jwt, 62800, 61262),
    "substring_100_in_1536": (_substring_100_in_1536, 13924, 15457),
    "string_bodies_1536": (_string_bodies_1536, 12284, 13821),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_gadget_constraint_counts(name):
    build, want_constraints, want_wires = PINNED[name]
    n_constraints, n_wires = _count(build)
    assert (n_constraints, n_wires) == (want_constraints, want_wires), (
        f"{name}: constraint/wire count changed "
        f"({n_constraints}, {n_wires}) != ({want_constraints}, {want_wires}) — "
        "if intentional, update PINNED and note the delta in the commit"
    )

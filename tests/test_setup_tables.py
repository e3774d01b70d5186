"""Setup table builders against host ints: the device fixed-base tables
(windowed, from a precomputed window table), the memoized coefficient
encoding, the zkey writer's round trip, and the YAML-free
circuit_config.yml writer."""

import numpy as np
import pytest

from keyless_zk_tpu.circuits import setup
from keyless_zk_tpu.curves import ref_curve
from keyless_zk_tpu.fields import bn254
from keyless_zk_tpu.fields.limbs import ints_to_limbs

R = bn254.R_SCALAR


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_fixed_base_table_matches_host(group):
    ops = ref_curve.G1 if group == "g1" else ref_curve.G2
    gen = ref_curve.G1_GEN if group == "g1" else ref_curve.G2_GEN
    ks = [0, 1, 2, 255, 256, R - 1, 12345678901234567890, (1 << 253) + 99]
    got = setup._fixed_base_table(ks, group, device_threshold=0)
    want = setup._fixed_base_table(ks, group, device_threshold=len(ks))  # host path
    assert np.array_equal(got.inf, want.inf) and got.inf[0] and not got.inf[1:].any()
    assert np.array_equal(got.x, want.x) and np.array_equal(got.y, want.y)
    # spot-check the host path itself against plain scalar multiplication
    tbl = setup._g1_table([ops.mul(gen, 5)]) if group == "g1" else setup._g2_table([ops.mul(gen, 5)])
    five = setup._fixed_base_table([5], group, device_threshold=1)
    assert np.array_equal(tbl.x, five.x) and np.array_equal(tbl.y, five.y)


def test_coef_limbs_matches_direct_encoding():
    vals = [1, R - 1, 2, 1, 7, R - 1, 1 << 200, 2]
    want = ints_to_limbs([c * (1 << 256) % R * (1 << 256) % R for c in vals])
    assert np.array_equal(setup._coef_limbs(vals), want)
    assert setup._coef_limbs([]).shape == (0, 16)


def test_native_setup_zkey_roundtrip(toy_setup, tmp_path):
    """A native setup's proving key survives save_zkey -> load_zkey, the
    route the service's persisted setups take."""
    from keyless_zk_tpu.groth16 import load_zkey
    from keyless_zk_tpu.groth16.zkey import save_zkey

    pk = toy_setup[1].pk
    path = str(tmp_path / "toy.zkey")
    save_zkey(path, pk)
    back = load_zkey(path)
    assert (back.n_vars, back.n_public, back.domain_size, back.n_coefs) == (
        pk.n_vars, pk.n_public, pk.domain_size, pk.n_coefs,
    )
    for name in ("vk_alpha1", "vk_beta1", "vk_beta2", "vk_gamma2", "vk_delta1", "vk_delta2"):
        assert getattr(back, name) == getattr(pk, name)
    for name in ("coef_m", "coef_c", "coef_s", "coef_val"):
        assert np.array_equal(getattr(back, name), getattr(pk, name))
    for name in ("points_a", "points_b1", "points_b2", "points_c", "points_h"):
        a, b = getattr(back, name), getattr(pk, name)
        assert np.array_equal(a.x, b.x) and np.array_equal(a.y, b.y)
        assert np.array_equal(a.inf, b.inf)


def test_circuit_config_yaml_roundtrip(tmp_path):
    from keyless_zk_tpu.circuits.keyless_circuit import KeylessConfig, to_circuit_config
    from keyless_zk_tpu.input_processing.circuit_config import CircuitConfig
    from keyless_zk_tpu.tooling.setup_tool import _circuit_config_yaml

    cc = to_circuit_config(KeylessConfig())
    path = tmp_path / "circuit_config.yml"
    path.write_text(_circuit_config_yaml(cc))
    back = CircuitConfig.from_yaml(str(path))
    assert back.max_lengths == cc.max_lengths
    assert back.has_input_skip_aud_checks == cc.has_input_skip_aud_checks

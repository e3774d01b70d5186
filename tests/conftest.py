"""Test config: run everything on a virtual 8-device CPU mesh.

Field and curve numerics are exact integer math, so a CPU run checks the
same bits the GPU computes, and the sharded paths need several devices,
which only the CPU backend can fake. Tests that need the card carry the
`gpu` marker and decide inside the `gpu_device` fixture (never at import)
whether to skip.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
# the CPU unless the caller names a platform (JAX_PLATFORMS=cuda for the
# `gpu`-marked tests on a card)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# Persistent compilation cache: the limb-arithmetic graphs are expensive for
# XLA:CPU; pay compile once per kernel shape.
from keyless_zk_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


@pytest.fixture
def gpu_device():
    """The first GPU device, or skip: this test run is held to the CPU."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU; this run has only the CPU backend")
    return devs[0]


@pytest.fixture(scope="session")
def toy_setup():
    """(cs, SetupResult) of a 60-multiplication chain circuit with one
    public input, which any inputs satisfy; native setup with fixed toxic
    waste, small enough for the host point tables."""
    from keyless_zk_tpu.circuits import ConstraintSystem
    from keyless_zk_tpu.circuits.r1cs_file import r1cs_from_cs
    from keyless_zk_tpu.circuits.setup import groth16_setup

    cs = ConstraintSystem()
    ws = [cs.public_wire()]
    cs.set_input_hint(ws, "a")
    for k in range(60):
        b = cs.new_wire()
        cs.set_input_hint([b], f"b{k}")
        ws.append(cs.mul(cs.lc(ws[-1]) + cs.lc(b), cs.lc(b)))
    toxic = dict(tau=11, alpha=13, beta=17, gamma=19, delta=23)
    return cs, groth16_setup(r1cs_from_cs(cs), toxic=toxic)

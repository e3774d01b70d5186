"""Native circuit framework: R1CS construction, witness generation, setup.

The reference expresses its relation in circom and leans on external
binaries (circom compiler, snarkjs setup, circom-generated witness
generators — SURVEY §2.2 "External native artifacts", §3.5).  This package
replaces that entire toolchain natively:

- :mod:`r1cs`      — constraint-system builder with integrated witness
                     program (each gadget emits constraints *and* the code
                     that computes its wires);
- :mod:`r1cs_file` — parser/writer for circom's binary ``.r1cs`` container,
                     so reference-compiled artifacts remain loadable;
- :mod:`setup`     — Groth16 setup producing proving keys for our prover
                     and snarkjs-shape verification keys (the fixed-base
                     scalar multiplications run as batched device kernels);
- :mod:`gadgets`   — the gadget library mirroring the reference's template
                     tree (circuit/templates/helpers/*).
"""

from .r1cs import ConstraintSystem, LinComb
from .setup import groth16_setup

__all__ = ["ConstraintSystem", "LinComb", "groth16_setup"]

"""Setup procurement: content-addressed circuit setups.

Mirror of the reference's scripts/python/setups pipeline (testing_setup.py:
102-124): setups are keyed by a checksum of the circuit definition, built
once, and installed under ~/.local/share/keyless_zk_tpu/setups/<hash> with
a `default` symlink — but fully native: the circuit compiles in-process and
the 1-party setup replaces `snarkjs groth16 setup` (no ptau download: the
powers of tau are sampled directly, which is exactly as (un)trusted as the
reference's testing setup).

    python -m keyless_zk_tpu.tooling.setup_tool procure-testing-setup
    python -m keyless_zk_tpu.tooling.setup_tool show
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import sys

from ..service.config import DEFAULT_SETUP_ROOT


def circuit_checksum(keyless_config) -> str:
    """Content hash of the circuit definition + parameters (the analog of
    checksumming circuit/templates/*.circom, testing_setup.py:25-29)."""
    from ..circuits import (
        base64_gadget,
        gadgets,
        hash_gadget,
        jwt_gadget,
        keyless_circuit,
        misc_gadgets,
        r1cs,
        rsa_gadget,
        sha256_gadget,
    )

    h = hashlib.sha256()
    for mod in (
        r1cs, gadgets, hash_gadget, jwt_gadget, misc_gadgets,
        rsa_gadget, sha256_gadget, base64_gadget, keyless_circuit,
    ):
        h.update(inspect.getsource(mod).encode())
    h.update(json.dumps(keyless_config.__dict__, sort_keys=True).encode())
    return h.hexdigest()[:16]


def procure(
    keyless_config=None,
    root: str = DEFAULT_SETUP_ROOT,
    force: bool = False,
    cs=None,
) -> str:
    """Build circuit + run setup + install; returns the setup directory.

    Pass a prebuilt ConstraintSystem as `cs` to skip the ~2 min circuit
    construction (callers that already built it, e.g. service startup)."""
    from ..circuits.keyless_circuit import KeylessConfig, build_keyless_circuit, to_circuit_config
    from ..circuits.r1cs_file import r1cs_from_cs, save_r1cs
    from ..circuits.setup import groth16_setup
    from ..groth16.zkey import save_zkey
    from ..utils.logging import Span

    kc = keyless_config or KeylessConfig()
    key = circuit_checksum(kc)
    target = os.path.join(root, key)
    marker = os.path.join(target, ".complete")
    if os.path.exists(marker) and not force:
        _set_default(root, key)
        return target

    os.makedirs(target, exist_ok=True)
    if cs is None:
        with Span("BuildCircuit"):
            cs = build_keyless_circuit(kc)
    with Span("ExportR1CS"):
        r = r1cs_from_cs(cs)
        save_r1cs(os.path.join(target, "main.r1cs"), r)
    with Span("Groth16Setup"):
        res = groth16_setup(r)
    with Span("WriteArtifacts"):
        save_zkey(os.path.join(target, "prover_key.zkey"), res.pk)
        with open(os.path.join(target, "verification_key.json"), "w") as f:
            json.dump(res.vk, f, indent=1)
        cc = to_circuit_config(kc)
        with open(os.path.join(target, "circuit_config.yml"), "w") as f:
            f.write(_circuit_config_yaml(cc))
        with open(os.path.join(target, "keyless_config.json"), "w") as f:
            json.dump(kc.__dict__, f, indent=1)
    open(marker, "w").close()
    _set_default(root, key)
    return target


def _circuit_config_yaml(cc) -> str:
    """circuit_config.yml text (flat string->int map + one bool), written
    without a YAML library so setup needs only the standard library."""
    lines = ["max_lengths:"]
    lines += [f"  {k}: {int(v)}" for k, v in sorted(cc.max_lengths.items())]
    lines.append(f"has_input_skip_aud_checks: {str(bool(cc.has_input_skip_aud_checks)).lower()}")
    return "\n".join(lines) + "\n"


def _set_default(root: str, key: str) -> None:
    set_slot(root, key, "default")


def set_slot(root: str, key: str, slot: str) -> None:
    """Point a named slot symlink (`default` or `new`) at a setup.

    Mirrors the reference's two-slot layout for staged circuit rollouts
    (scripts/python/setups/__init__.py:10-28: a service can load the
    `default` setup while the `new` one is procured/validated, then flip).
    """
    if slot not in ("default", "new"):
        raise ValueError("slot must be 'default' or 'new'")
    if not os.path.isdir(os.path.join(root, key)):
        raise FileNotFoundError(f"setup {key} not found under {root}")
    link = os.path.join(root, slot)
    if os.path.islink(link):
        os.unlink(link)
    if not os.path.exists(link):
        os.symlink(key, link)


def import_zkey(
    zkey_path: str,
    vk_path: str | None = None,
    circuit_config_path: str | None = None,
    root: str = DEFAULT_SETUP_ROOT,
    slot: str = "new",
) -> str:
    """Install an externally-procured (ceremony / snarkjs) zkey into the
    content-addressed store.

    The analog of the reference's release-ceremony download
    (scripts/python/setups/gh_release.py): the setup key is the zkey file's
    content hash; the verification key is extracted from the zkey header if
    no snarkjs VK JSON is supplied; a warm device-format table cache is
    built immediately so first service start doesn't pay the conversion.
    """
    import shutil

    from ..groth16.zkey import load_zkey
    from ..tooling.onchain_vk import vk_json_from_pk

    h = hashlib.sha256()
    with open(zkey_path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    key = "zkey-" + h.hexdigest()[:16]
    target = os.path.join(root, key)
    marker = os.path.join(target, ".complete")
    if not os.path.exists(marker):
        os.makedirs(target, exist_ok=True)
        dest = os.path.join(target, "prover_key.zkey")
        shutil.copyfile(zkey_path, dest)
        # parse + write the device-format table cache beside the store copy
        pk = load_zkey(dest, cache_path=dest + ".tables.npz")
        if vk_path:
            shutil.copyfile(vk_path, os.path.join(target, "verification_key.json"))
        else:
            with open(os.path.join(target, "verification_key.json"), "w") as f:
                json.dump(vk_json_from_pk(pk), f, indent=1)
        if circuit_config_path:
            shutil.copyfile(
                circuit_config_path, os.path.join(target, "circuit_config.yml")
            )
        open(marker, "w").close()
    set_slot(root, key, slot)
    return target


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="keyless-zk-tpu-setup")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("procure-testing-setup")
    pr.add_argument("--root", default=DEFAULT_SETUP_ROOT)
    pr.add_argument("--force", action="store_true")
    im = sub.add_parser(
        "import-zkey", help="install an external snarkjs/ceremony zkey"
    )
    im.add_argument("zkey")
    im.add_argument("--vk", help="snarkjs VK JSON (else recovered from the zkey)")
    im.add_argument("--circuit-config", help="circuit_config.yml to ship with it")
    im.add_argument("--root", default=DEFAULT_SETUP_ROOT)
    im.add_argument("--slot", default="new", choices=["default", "new"])
    ss = sub.add_parser("set-slot", help="point default/new at an installed setup")
    ss.add_argument("key")
    ss.add_argument("--slot", required=True, choices=["default", "new"])
    ss.add_argument("--root", default=DEFAULT_SETUP_ROOT)
    dc = sub.add_parser(
        "download-ceremony",
        help="fetch a released trusted-setup ceremony (GitHub releases) "
        "and install it (gh_release.py/ceremony_setup.py analog)",
    )
    dc.add_argument("release")
    dc.add_argument("--repo", default="aptos-labs/keyless-zk-proofs")
    dc.add_argument("--auth-token", default=os.environ.get("GITHUB_TOKEN"))
    dc.add_argument(
        "--checksum",
        action="append",
        default=[],
        metavar="ASSET=SHA256",
        help="pin an asset's sha256 (repeatable); mismatch aborts",
    )
    dc.add_argument("--root", default=DEFAULT_SETUP_ROOT)
    dc.add_argument("--slot", default="new", choices=["default", "new"])
    cp = sub.add_parser("cache-push", help="tar.gz a setup to a remote cache")
    cp.add_argument("setup_dir")
    cp.add_argument("--remote", required=True)
    cl = sub.add_parser("cache-pull", help="fetch a setup from a remote cache")
    cl.add_argument("key")
    cl.add_argument("--remote", required=True)
    cl.add_argument("--root", default=DEFAULT_SETUP_ROOT)
    cl.add_argument("--slot", choices=["default", "new"])
    sub.add_parser("show")
    args = ap.parse_args(argv)

    if args.cmd == "procure-testing-setup":
        path = procure(root=args.root, force=args.force)
        print(path)
        return 0
    if args.cmd == "import-zkey":
        path = import_zkey(
            args.zkey,
            vk_path=args.vk,
            circuit_config_path=args.circuit_config,
            root=args.root,
            slot=args.slot,
        )
        print(path)
        return 0
    if args.cmd == "set-slot":
        set_slot(args.root, args.key, args.slot)
        return 0
    if args.cmd == "download-ceremony":
        from .ceremony import download_ceremony

        checks = dict(kv.split("=", 1) for kv in args.checksum)
        path = download_ceremony(
            args.release,
            root=args.root,
            repo=args.repo,
            auth_token=args.auth_token,
            checksums=checks or None,
            slot=args.slot,
        )
        print(path)
        return 0
    if args.cmd == "cache-push":
        from .ceremony import cache_push

        print(cache_push(args.setup_dir, args.remote))
        return 0
    if args.cmd == "cache-pull":
        from .ceremony import cache_pull

        path = cache_pull(args.key, args.remote, root=args.root, slot=args.slot)
        if path is None:
            print("not found in cache", file=sys.stderr)
            return 1
        print(path)
        return 0
    root = DEFAULT_SETUP_ROOT
    if os.path.isdir(root):
        for entry in sorted(os.listdir(root)):
            print(entry)
    return 0


if __name__ == "__main__":
    sys.exit(main())

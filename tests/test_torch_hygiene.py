"""Import and device hygiene of the port (tendermint_tpu_torch).

- Importing every module of the port (lite/ included), and chip_smoke.py
  as a module, in a fresh interpreter loads neither jax nor any
  tendermint_tpu module.
- No source of the port (nor chip_smoke.py) imports them (AST check).
- No C++/CUDA source of the port's csrc/ includes a file outside csrc/
  (system headers aside).
- An entry point given no device raises when no CUDA device is present:
  the port never moves to the CPU quietly.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "tendermint_tpu_torch"
# the package's own sources; _build/ holds build outputs, not sources
PORT_SOURCES = sorted(p for p in PORT.rglob("*.py")
                      if "_build" not in p.relative_to(PORT).parts)
SOURCES = PORT_SOURCES + [REPO / "chip_smoke.py"]


def test_walk_covers_every_subpackage():
    mods = set(_modules())
    for pkg in ("ops", "types", "models", "utils", "lite"):
        assert f"tendermint_tpu_torch.{pkg}" in mods, pkg
    assert "tendermint_tpu_torch.lite.certifier" in mods
    assert "tendermint_tpu_torch.native" in mods
    for mod in ("ops.sha256", "ops.merkle", "types.block", "types.part_set",
                "types.vote_set", "types.evidence", "types.params",
                "types.genesis", "types.proposal", "types.priv_validator",
                "convert"):
        assert f"tendermint_tpu_torch.{mod}" in mods, mod


CSRC = PORT / "csrc"
CSRC_SOURCES = sorted(p for p in CSRC.iterdir()
                      if p.suffix in (".h", ".cuh", ".cpp", ".cu"))


@pytest.mark.parametrize("path", CSRC_SOURCES, ids=lambda p: p.name)
def test_csrc_includes_nothing_outside_csrc(path):
    """Quoted includes name a file of csrc/ itself; angle includes are
    system and toolkit headers, never a path into the repository."""
    for ln in path.read_text().splitlines():
        m = re.match(r'\s*#\s*include\s*([<"])([^>"]+)[>"]', ln)
        if not m:
            continue
        name = m.group(2)
        assert "tendermint_tpu" not in name and ".." not in name, (path, ln)
        if m.group(1) == '"':
            assert "/" not in name and (CSRC / name).is_file(), (path, ln)


def _modules():
    for p in PORT_SOURCES:
        rel = p.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib") or top == "tendermint_tpu"


def test_port_imports_no_jax_in_a_fresh_interpreter():
    mods = list(_modules()) + ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tendermint_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_port_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


@pytest.fixture
def no_cuda(monkeypatch):
    """This machine has no card; on one that has, pretend it has none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_raise(no_cuda):
    from tendermint_tpu_torch import convert
    from tendermint_tpu_torch.models import verifier
    from tendermint_tpu_torch.ops import ed25519, ladder

    with pytest.raises(RuntimeError, match="no CUDA device"):
        verifier.BatchVerifier()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verifier.BatchVerifier("cuda")
    saved = verifier._default
    verifier.set_default_verifier(None)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            verifier.default_verifier()
    finally:
        verifier.set_default_verifier(saved)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ed25519.verify_batch([b"\x00" * 32], [b""], [b"\x00" * 64])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.state_from_jax(*ladder.tables())
    # the scalar backend needs no device
    assert verifier.BatchVerifier("python").verify([]).shape == (0,)


def test_device_merkle_without_device_raises(no_cuda):
    from tendermint_tpu_torch.ops import merkle

    for items in ([b"a", b"b"], []):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            merkle.root(items)
    # the host half needs no device
    assert merkle.root_host([b"a", b"b"]) == merkle.root([b"a", b"b"],
                                                          device="cpu")


def test_sign_batch_without_device_raises(no_cuda):
    from tendermint_tpu_torch.ops import ed25519

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ed25519.sign_batch([b"\x01" * 32], [b"m"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ed25519.sign_batch_async([b"\x01" * 32], [b"m"])

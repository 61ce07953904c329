"""The port stands alone: importing every ``repro_torch`` module loads
neither JAX nor the reference package, and no port source (nor
``chip_smoke.py``, which drives the port on the card, nor the tools
beside it) imports them."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_modules() -> list[str]:
    return sorted(
        m.name
        for m in pkgutil.walk_packages([str(PORT)], prefix="repro_torch.")
    )


def _import_in_subprocess(mods: list[str]) -> None:
    """Import ``mods`` in a fresh interpreter; fail if JAX or the
    reference package was loaded on the way."""
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr


def test_importing_the_port_loads_no_jax():
    mods = _port_modules()
    assert "repro_torch.query.scheduler" in mods and "repro_torch.kernels.mws.ops" in mods
    assert "repro_torch.train.trainer" in mods and "repro_torch.kernels.signcomp.ops" in mods
    assert "repro_torch.kernels.mws_count.ops" in mods
    assert "repro_torch.query.shard" in mods
    assert "repro_torch.models.moe" in mods and "repro_torch.launch.serve" in mods
    assert {"repro_torch.models.xlstm", "repro_torch.models.rglru", "repro_torch.models.encdec"} <= set(mods)
    assert {
        "repro_torch.distributed.sharding",
        "repro_torch.launch.mesh",
        "repro_torch.launch.dryrun",
        "repro_torch.launch.hlo_analysis",
        "repro_torch.launch.roofline",
        "repro_torch.launch.perf",
    } <= set(mods)
    _import_in_subprocess(mods)


@pytest.mark.parametrize(
    "mod",
    [
        "repro_torch.models",
        "repro_torch.train",
        "repro_torch.configs",
        "repro_torch.data",
        "repro_torch.launch.train",
        "repro_torch.launch.serve",
        "repro_torch.distributed",
        "repro_torch.distributed.sharding",
        "repro_torch.launch.mesh",
        "repro_torch.launch.dryrun",
        "repro_torch.launch.hlo_analysis",
        "repro_torch.launch.roofline",
        "repro_torch.launch.perf",
    ],
)
def test_the_training_stack_loads_no_jax(mod):
    """Each entry point of the training and serving slices, imported on
    its own."""
    _import_in_subprocess([mod])


def test_the_sharded_fleet_loads_no_jax():
    """``repro_torch.query.shard``, imported on its own."""
    _import_in_subprocess(["repro_torch.query.shard"])


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [SRC.parent / "chip_smoke.py"] + sorted((SRC.parent / "tools").glob("*.py")),
    ids=lambda p: str(p.relative_to(SRC.parent)),
)
def test_no_port_source_imports_jax_or_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"

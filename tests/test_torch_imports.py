"""The port imports nothing of JAX and nothing of the JAX package, nor
``ml_dtypes`` (the card's machine has none: the port carries bf16 span
arrays as their bit patterns).

In a child process (so that this test process's own imports do not
count), every module of ``repro_torch`` is imported through
``pkgutil.walk_packages``; afterwards none of ``jax``, ``repro`` and
``ml_dtypes`` (nor any of their submodules) may be in ``sys.modules``.
Then, statically, no port source file and not ``chip_smoke.py`` names
one in an ``import`` statement, at any depth (imports inside functions
included: the port builds and loads its kernels lazily).
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "repro", "ml_dtypes")

CHILD = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if any(m == f or m.startswith(f + ".") for f in %r))
print(json.dumps({"modules": names, "forbidden": bad}))
""" % (FORBIDDEN,)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_every_port_module_loads_no_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", CHILD], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == [], got["forbidden"]
    # the walk reached the whole package, this slice's modules included
    mods = set(got["modules"])
    for want in ("repro_torch.models.paper_nets", "repro_torch.simulator",
                 "repro_torch.simulator.stats", "repro_torch.serving.engine",
                 "repro_torch.kernels.log2quant.ops",
                 "repro_torch.serving.workers", "repro_torch.serving.router",
                 "repro_torch.tree", "repro_torch.data.pipeline",
                 "repro_torch.optim.adamw", "repro_torch.train.trainer",
                 "repro_torch.checkpoint.manager",
                 "repro_torch.launch.train"):
        assert want in mods, want
    files = {p for p in PORT.rglob("*.py") if "build" not in p.parts}
    assert len(mods) + 1 >= len(files)      # + the package's __init__


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("root", ["src/repro_torch", "chip_smoke.py"])
def test_no_source_names_jax_or_reference_in_an_import(root):
    path = REPO / root
    files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
    assert files
    bad = [f"{f.relative_to(REPO)}:{line} {name}" for f in files
           for line, name in _imports(f) if _forbidden(name)]
    assert bad == []

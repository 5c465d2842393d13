"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``,
nor an example of the port, ``examples/torch_*.py``) imports ``jax`` or
anything of the JAX package ``repro``."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s+import)\b)", re.M)

IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(m == "jax" or m.startswith(("jax.", "repro.")) for m in sys.modules
               if sys.modules[m] is not None), "jax or repro was imported"
print(" ".join(names))
"""

#: subpackages whose modules are copies of JAX-free reference modules, or
#: the parallel layer and launch tooling: the walk must reach them, and each
#: must import without ``repro``
SUBPACKAGES = ("repro_torch.core.tee", "repro_torch.tee_stream", "repro_torch.core.tol",
               "repro_torch.sim", "repro_torch.recovery", "repro_torch.substrate",
               "repro_torch.parallel", "repro_torch.launch", "repro_torch.fleet")


def test_every_module_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) == len(list(PKG.rglob("*.py"))) - 1   # every module but the top __init__
    for pkg in SUBPACKAGES:
        want = {f"{pkg}.{p.stem}" if p.stem != "__init__" else pkg
                for p in (PKG / pkg.split(".", 1)[1].replace(".", "/")).glob("*.py")}
        assert want <= set(names), sorted(want - set(names))


EXAMPLES = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "examples").glob("torch_*.py"))


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py"))
                         + ["chip_smoke.py"] + EXAMPLES)
def test_source_has_no_jax_or_repro_import(path):
    src = (ROOT / path).read_text()
    assert not FORBIDDEN.search(src), FORBIDDEN.search(src).group(0)


def test_examples_import_without_jax_or_repro():
    assert len(EXAMPLES) == 4
    code = ("import importlib.util, sys\n"
            "sys.modules['jax'] = None\nsys.modules['repro'] = None\n"
            "for path in sys.argv[1:]:\n"
            "    spec = importlib.util.spec_from_file_location('ex', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code, *(str(ROOT / p) for p in EXAMPLES)],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

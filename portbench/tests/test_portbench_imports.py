"""No run loads JAX or the JAX package, and the reference loads nothing of
the program.  Module names are compared by their whole top-level name:
`geodiffuser_tpu_torch` begins with `geodiffuser_tpu`."""

import json
import subprocess
import sys

from portbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "geodiffuser_tpu"}

RUN_TINY = r"""
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import tiny
from portbench import run
for name in {cells!r}:
    w, c, t = tiny.cell(name)
    run.run_cell(w, c, t, 7, 0.0, True, "cpu", run.benchmark())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = r"""
import json, sys, pkgutil, importlib
sys.path.insert(0, {root!r})
import portbench.reference
for mod in pkgutil.walk_packages(portbench.reference.__path__, "portbench.reference."):
    importlib.import_module(mod.name)
import portbench.drivers.edit_groups, portbench.drivers.dift_images  # the drivers import lazily
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    cells = [w["name"] for w in run.benchmark()["workloads"]]
    mods = _top_level(RUN_TINY.format(root=str(run.ROOT), tests=str(run.ROOT / "portbench" / "tests"),
                                      cells=cells))
    assert "geodiffuser_tpu_torch" in mods     # the program did run
    assert not mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level(REFERENCE.format(root=str(run.ROOT)))
    assert not mods & (FORBIDDEN | {"geodiffuser_tpu_torch"})


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "geodiffuser_tpu_torch_extra", sys)
    assert "geodiffuser_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]

"""The port stands alone: no file of ``monocular_visual_odometry_va4mr_torch``
and neither ``chip_smoke.py`` nor ``kernel_ab.py`` imports ``jax`` or the JAX
package.  The check reads the source text with ``ast``; it imports
nothing."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "monocular_visual_odometry_va4mr_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax",
             "monocular_visual_odometry_va4mr_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "kernel_ab.py"]


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_sources_are_found():
    names = {p.name for p in SOURCES}
    assert {"vo.py", "runner.py", "klt_pallas.py", "chip_smoke.py",
            "kernel_ab.py"} <= names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"

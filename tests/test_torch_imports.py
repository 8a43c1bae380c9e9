"""The port stands alone: no file of ``monocular_visual_odometry_va4mr_torch``
(its measuring tools under ``tools/`` included) and none of ``chip_smoke.py``, ``kernel_ab.py`` and ``stress_diag.py``
imports ``jax``, the JAX package or ``cv2`` (the card's machine has none).
And the port is whole: a module for every module of the JAX package, and in
it every public name of the JAX module (a top-level function, class or
assignment), save the named exceptions.  The checks read the source text
with ``ast``; they import nothing."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "monocular_visual_odometry_va4mr_torch"
JAX_PKG = ROOT / "monocular_visual_odometry_va4mr_tpu"
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "cv2",
             "monocular_visual_odometry_va4mr_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "kernel_ab.py",
                                        ROOT / "stress_diag.py"]


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
    assert {"vo.py", "runner.py", "klt_pallas.py", "sift.py", "match.py",
            "posegraph.py", "posegraph_sim3.py", "posegraph_runner.py",
            "datasets.py", "native_io.py", "dashboard.py", "seq_dp.py",
            "multi_seq.py", "ba_sharded.py", "traj_ba.py", "multihost.py",
            "chip_smoke.py", "kernel_ab.py", "stress_diag.py"} <= names
    # The measuring tools, which stand in for the JAX side's bench.py and
    # tools/ and run on the card's machine, where there is no jax or cv2.
    tools = {p.name for p in SOURCES if p.parent == PORT / "tools"}
    assert {"harness.py", "bench.py", "bench_datasets.py", "profile_step.py",
            "diag_tracker.py", "stress_klt_motion.py", "bench_stream.py",
            "bench_stream_2761.py", "make_kitti_seq.py",
            "bench_native_decode.py", "profile_ba.py", "profile_branch.py",
            "profile_trigger.py", "diag_ba.py", "bench_ba_scaling.py",
            "traj_ba_convergence.py", "diag_e2e.py", "diag_drift.py",
            "diag_survival.py", "exp_ate.py"} <= tools


# The JAX tools/ scripts the port does not carry: run_reference.py drives
# the reference's code through cv2, and neither is on the card's machine.
# diag_ba_tpu.py is ported as tools/diag_ba.py.
UNPORTED_TOOLS = {"run_reference.py"}
RENAMED_TOOLS = {"diag_ba_tpu.py": "diag_ba.py"}


def test_the_port_has_every_jax_tool():
    jax_tools = {p.name for p in (ROOT / "tools").glob("*.py")}
    missing = [n for n in sorted(jax_tools - UNPORTED_TOOLS)
               if not (PORT / "tools" / RENAMED_TOOLS.get(n, n)).exists()]
    assert not missing, f"JAX tools not ported: {missing}"


def test_the_port_has_every_module_of_the_jax_package():
    missing = [str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py")
               if not (PORT / p.relative_to(JAX_PKG)).exists()]
    assert not missing, f"modules of the JAX package not ported: {missing}"


# Public names of JAX modules that the port does not carry, by module: the
# TPU kernel's slab layout (rows, target row, lanes per feature, features
# per program), which the CUDA kernel replaces with its own, and the
# decoder's availability probe (the port builds its decoder at first use
# and raises if it cannot: nothing falls back).
UNPORTED_NAMES = {
    "ops/klt_pallas2.py": {"R", "TGT", "PITCH", "BF"},
    "dataio/native_io.py": {"available"},
}


def top_level_names(path, imports=False):
    """Public names a module defines at top level (and, if ``imports``, the
    names it imports there)."""
    out = set()
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                out.update(n.id for n in ast.walk(t)
                           if isinstance(n, ast.Name))
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
    return {n for n in out if not n.startswith("_")}


JAX_NAMES = [(module, name)
             for module in sorted(str(p.relative_to(JAX_PKG))
                                  for p in JAX_PKG.rglob("*.py"))
             for name in sorted(top_level_names(JAX_PKG / module)
                                - UNPORTED_NAMES.get(module, set()))]


def test_unported_names_are_names_of_the_jax_package():
    """Each exception names a public name the JAX module has and the port
    lacks, so the list cannot go stale."""
    for module, names in UNPORTED_NAMES.items():
        assert names <= top_level_names(JAX_PKG / module), module
        assert not names & top_level_names(PORT / module, imports=True), \
            module


@pytest.mark.parametrize("module,name", JAX_NAMES,
                         ids=[f"{m}::{n}" for m, n in JAX_NAMES])
def test_the_port_has_every_public_name_of_the_jax_package(module, name):
    assert name in top_level_names(PORT / module, imports=True), \
        f"{module}::{name} is not in the port"


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"

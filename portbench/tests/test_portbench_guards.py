"""What the benchmark may import, and that it never falls back to the
CPU."""

import ast
import importlib.util
import os
import pathlib
import subprocess
import sys

from portbench.lib import spec

PKG = spec.PKG
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: pathlib.Path) -> set[str]:
    """Top-level names of every module ``path`` imports (relative imports
    are the benchmark's own)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources():
    return sorted(PKG.rglob("*.py"))


def test_no_module_imports_jax_or_the_jax_package():
    assert _sources()
    for f in _sources():
        bad = _imports(f) & FORBIDDEN
        assert not bad, f"{f.relative_to(PKG)} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((PKG / "reference").glob("*.py")):
        names = _imports(f)
        assert "repro_torch" not in names, f
        assert names <= {"__future__", "torch", "math", "portbench"}, \
            (f, names)
        src = f.read_text()
        assert "portbench.lib" not in src and "repro" not in src, f


def _runner():
    s = importlib.util.spec_from_file_location("pb_run", PKG / "run.py")
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    return m


def test_guard_compares_whole_top_level_names():
    run = _runner()
    assert run.forbidden_modules(["repro_torch", "repro_torch.serve",
                                  "reprox", "jax_like"]) == []
    assert run.forbidden_modules(["repro.serve.engine", "jax.numpy",
                                  "jaxlib", "flax.linen", "torch"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, str(PKG / "run.py"), "--workload", "qwen2-7b.chat",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr

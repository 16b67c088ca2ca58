"""The port's surface against the JAX package's, by AST (no JAX import).

Every module of ``src/repro/`` has a counterpart at the same path under
``src/repro_torch/``, and each of its public top-level names (a ``def``, a
``class`` or an assignment whose name does not start with ``_``; for a
package ``__init__``, also the names it re-exports) is a top-level name of
that counterpart, or a submodule of it.  The exceptions are the one table
below, each with its reason; each is checked to still exist on the JAX
side and to still be a gap, so the table cannot go stale.
"""

import ast
import pathlib

import pytest

pytestmark = pytest.mark.torch_port

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
JAX, PORT = SRC / "repro", SRC / "repro_torch"

#: JAX module -> why it has no counterpart at its own path (the port's
#: module that takes its place, if any, and whose names are not compared)
MODULES = {
    "kernels/common.py": (None, "Pallas-TPU compiler parameters and the "
                                "interpret switch; CUDA kernels take none"),
    "launch/hlo_cost.py": ("launch/op_cost.py",
                           "counts a TorchDispatchMode's ops, not XLA HLO "
                           "text (HloCostModel, Instr read HLO)"),
    "launch/hlo_analysis.py": ("launch/analysis.py",
                               "the roofline on the H100's constants; "
                               "shape_bytes / parse_collectives read HLO "
                               "text"),
}

#: (JAX module, name) -> (the port's module holding its counterpart, and
#: that name; or None) and the reason
NAMES = {
    ("core/costmodel.py", "TPU_PEAK_FLOPS_BF16"): (
        ("core/costmodel.py", "H100_PEAK_FLOPS_BF16"), "the card's constant"),
    ("core/costmodel.py", "TPU_HBM_BW"): (
        ("core/costmodel.py", "H100_HBM_BW"), "the card's constant"),
    ("core/costmodel.py", "TPU_HBM_BYTES"): (
        ("core/costmodel.py", "H100_HBM_BYTES"), "the card's constant"),
    ("core/costmodel.py", "TPU_ICI_BW_PER_LINK"): (
        ("core/costmodel.py", "H100_NET_BW"),
        "the card's constant (the link a mesh's collectives cross)"),
    ("core/costmodel.py", "TPU_VMEM_BYTES"): (
        None, "the TPU core's vector scratchpad; nothing reads it"),
    ("launch/mesh.py", "compat_make_mesh"): (
        None, "a JAX-version shim (axis_types)"),
    ("launch/mesh.py", "use_mesh"): (
        None, "a JAX-version shim (jax.set_mesh); a DeviceMesh is passed "
              "explicitly"),
    ("kernels/ref.py", "wkv6_chunked_ref"): (
        None, "the by-design divergence of ROADMAP Queue 3: the port's "
              "chunked kernel is held to the sequential oracle"),
    ("models/moe.py", "moe_apply_ragged_batched"): (
        None, "a jax.vmap shim over moe_apply_ragged"),
    ("models/transformer.py", "ShardFn"): (None, "a type alias"),
    ("models/rglru.py", "RGLRU_C"): (
        ("kernels/ref.py", "RGLRU_C"), "sits beside the plain RG-LRU"),
    ("launch/__init__.py", "make_host_mesh"): (
        ("launch/mesh.py", "make_host_mesh"),
        "not re-exported by the subpackage"),
    ("launch/__init__.py", "make_production_mesh"): (
        ("launch/mesh.py", "make_production_mesh"),
        "not re-exported by the subpackage"),
}


def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def defined(path: pathlib.Path) -> set[str]:
    """Top-level names bound by ``def``, ``class`` or assignment."""
    out = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
    return out


def bound(path: pathlib.Path) -> set[str]:
    """Every top-level name: defined, or imported."""
    out = defined(path)
    for node in _tree(path).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def public(rel: str) -> set[str]:
    """The JAX module's public top-level names (an ``__init__``'s
    re-exports too)."""
    path = JAX / rel
    names = bound(path) if path.name == "__init__.py" else defined(path)
    return {n for n in names if not n.startswith("_")}


def port_has(rel: str, name: str) -> bool:
    """``name`` is a top-level name of the port's ``rel``, or (for a
    package) a submodule of it."""
    path = PORT / rel
    if not path.is_file():
        return False
    if name in bound(path):
        return True
    pkg = path.parent
    return path.name == "__init__.py" and (
        (pkg / f"{name}.py").is_file() or (pkg / name / "__init__.py").is_file())


JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def test_the_jax_tree_is_found():
    assert len(JAX_MODULES) > 50
    assert "serve/reference.py" in JAX_MODULES


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_jax_module_has_a_counterpart(rel):
    if rel in MODULES:
        stand_in, reason = MODULES[rel]
        assert reason
        assert not (PORT / rel).exists(), f"{rel} is ported now: drop it"
        assert stand_in is None or (PORT / stand_in).is_file(), stand_in
        return
    assert (PORT / rel).is_file(), f"src/repro/{rel} has no port"


@pytest.mark.parametrize("rel", [r for r in JAX_MODULES if r not in MODULES])
def test_every_public_name_has_a_counterpart(rel):
    missing = sorted(n for n in public(rel)
                     if (rel, n) not in NAMES and not port_has(rel, n))
    assert not missing, f"src/repro/{rel}: no counterpart for {missing}"


@pytest.mark.parametrize("rel,name", sorted(NAMES))
def test_each_name_exception_still_stands(rel, name):
    """The JAX side still defines the name, the port still lacks it at the
    same path, and a named stand-in exists."""
    stand_in, reason = NAMES[rel, name]
    assert reason
    assert name in public(rel), f"src/repro/{rel} no longer has {name}"
    assert not port_has(rel, name), f"{rel}:{name} is ported now: drop it"
    if stand_in is not None:
        assert port_has(*stand_in), stand_in


def test_reference_engine_is_no_longer_a_gap():
    assert port_has("serve/reference.py", "ReferenceEngine")
    assert port_has("serve/__init__.py", "ReferenceEngine")
    assert {"spill", "can_restore", "restore"} <= {
        n.name for c in _tree(PORT / "core/context_switch.py").body
        if isinstance(c, ast.ClassDef) and c.name == "ContextSwitcher"
        for n in c.body if isinstance(n, ast.FunctionDef)}

"""Guards of the PyTorch port's boundary.

* No module of ``src/repro_torch`` (and not ``chip_smoke.py``) imports
  ``jax``, ``jaxlib`` or anything of the JAX package ``repro``: checked on
  the AST of every file, and by importing every module with ``jax``
  blocked.
* Entry points built without ``device=`` run on the CUDA card and raise on
  a machine with none, instead of quietly running on the CPU.
"""

import ast
import importlib
import pathlib
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.core import VirtualMemory, VMemConfig
from repro_torch.models import RWKV6LM, TransformerLM, build_model

pytestmark = pytest.mark.torch_port

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = pathlib.Path(repro_torch.__file__).resolve().parent
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_roots(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_import(path):
    bad = imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_every_module_imports_with_jax_blocked():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_model_without_device_raises_on_a_machine_with_no_card(no_cuda):
    cfg = get_config("qwen2-7b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerLM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    rwkv = get_config("rwkv6-7b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        RWKV6LM(rwkv)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(rwkv)
    vm = VirtualMemory(VMemConfig(page_size=4, num_pages=4,
                                  max_pages_per_seq=2, max_seqs=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        vm.device_page_table()


def test_serve_launcher_without_device_raises(no_cuda, monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", ["serve", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main()


def test_quickstart_without_device_raises(no_cuda, monkeypatch):
    from repro_torch.launch import quickstart
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main()
    monkeypatch.setattr(sys, "argv", ["quickstart"])
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart._cli()


def test_chip_smoke_fails_without_a_card(no_cuda, capsys):
    sys.path.insert(0, str(ROOT))
    try:
        chip_smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.main() != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out

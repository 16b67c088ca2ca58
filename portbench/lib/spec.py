"""Find every piece of a cell by name: ``BENCHMARK.json`` at the checkout's
root, ``configs/<config>.json``, ``traffic/<mix>.json`` and its
generator ``traffic/<kind>.py``, ``metrics/<metric>.py`` and
``work/<family>.py``.  Modules are loaded from their files, so a name may
hold dots (``metrics/idle_pct.open.py``)."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
from types import ModuleType

PKG = pathlib.Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def mix(name: str) -> dict:
    return load_json(PKG / "traffic" / f"{name}.json")


def module(kind: str, name: str) -> ModuleType:
    """``portbench/<kind>/<name>.py`` as a module (loaded once)."""
    key = f"portbench.{kind}.{name}"
    mod = sys.modules.get(key)
    if mod is not None:
        return mod
    path = PKG / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"{path} (named by the benchmark) is missing")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def dims(conf: dict) -> dict:
    """A configuration file's model sizes under short names (the file keeps
    the published ``config.json`` keys)."""
    heads = conf["num_attention_heads"]
    d = conf["hidden_size"]
    return dict(
        family=conf["family"],
        layers=conf["num_hidden_layers"],
        d=d,
        heads=heads,
        kv_heads=conf["num_key_value_heads"],
        head_dim=conf.get("head_dim", d // heads),
        ffn=conf["intermediate_size"],
        vocab=conf["vocab_size"],
        experts=conf.get("num_local_experts", 0),
        top_k=conf.get("num_experts_per_tok", 0),
        qkv_bias=conf.get("qkv_bias", False),
        norm_eps=conf["rms_norm_eps"],
        rope_theta=float(conf["rope_theta"]),
    )


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell_name`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]

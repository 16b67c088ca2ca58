"""Every name in ``BENCHMARK.json`` resolves to its files, and the file keeps
the shape its readers expect."""

import re

import pytest

from portbench.lib import spec

B = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in B["workloads"]]
E2E = {m["name"]: m for m in B["end_to_end"]}


def test_top_level_keys_and_paths():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["portbench"]
    assert B["command"][1] == "portbench/run.py"
    n = 24
    assert (2 + 14 * n) * (B["run_seconds"] + 60) + n * 180 + 1200 <= 43200


def test_names_and_units():
    names = ([c["name"] for c in B["configs"]] + CELLS
             + [m["name"] for m in B["end_to_end"] + B["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in B["configs"]:
        for k in c["reduced"]:
            assert NAME.match(k), k
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("conf", B["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    assert conf["file"].startswith("portbench/configs/")
    data = spec.config(B, conf["name"])
    assert data["name"] == conf["name"]
    assert data["reduced"] == conf["reduced"]
    spec.module("reference", data["reference"]).logits_at
    d = spec.dims(data)
    assert d["heads"] % d["kv_heads"] == 0


@pytest.mark.parametrize("cell", B["workloads"], ids=lambda c: c["name"])
def test_cell_resolves(cell):
    assert cell["chips"] in (1, 4)
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    spec.config(B, cell["config"])
    mix = spec.mix(cell["traffic"])
    assert hasattr(spec.module("traffic", mix["kind"]), "schedule")
    lim = spec.load_json(spec.PKG / "limits" / f"{cell['name']}.json")
    assert lim
    reported = spec.metrics_of(B, cell["name"], False)
    assert "setup_s" in [m["name"] for m in reported]
    assert len(reported) >= 2
    assert spec.metrics_of(B, cell["name"], True)


def test_end_to_end_bounds():
    assert E2E["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
        for w in m.get("workloads", []):
            assert w in CELLS


@pytest.mark.parametrize("m", B["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_resolves(m):
    assert callable(spec.module("metrics", m["name"]).read)
    assert m["moves"] in E2E
    assert "\n" not in m["layer"] and 0 < len(m["layer"]) <= 200
    for w in m.get("workloads", CELLS):
        assert w in CELLS
        reports = E2E[m["moves"]].get("workloads", CELLS)
        assert w in reports, (m["name"], w)
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"
        fam = m["name"][: -len("_roofline")]
        assert spec.module("work", fam).KERNELS


def test_each_roofline_has_a_step_share_beside_it():
    moved = {m["moves"] for m in B["per_layer"] if "_roofline" in m["name"]}
    mfu = {m["moves"] for m in B["per_layer"] if "mfu" in m["name"]}
    assert moved <= mfu


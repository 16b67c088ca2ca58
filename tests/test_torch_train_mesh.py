"""Training on a ('data', 'model') mesh: the port's ``launch/sharding.py``,
``make_train_step(grad_shardings=...)``, ``Trainer(mesh=...)``, the mesh
``make_global_batch``, ``compressed_psum_tree``, resharding restore and
``launch/train.py --data D --model M``, against the JAX package.

Two parts:

  * the layout rules, with no processes: for every leaf of every
    family's full-width config (JAX's shapes from ``jax.eval_shape``, the
    port's from its model built on ``meta``) the port's ``spec_for``
    equals JAX's ``_spec_for`` with the stacked dim dropped, on fake
    meshes {data 16, model 16}, {pod 2, data 16, model 16} and {data 4,
    model 2}, with FSDP and without, and on the ('kv', 'hd') serve view;
    so do ``batch_shardings``, ``serve_shardings`` and the shard hook's
    specs (JAX's captured by patching ``with_sharding_constraint``);
  * gloo runs: one module fixture starts, all at once, 4 gloo ranks of
    ``tests/torch_train_mesh_worker.py``, the JAX reference
    ``tests/jax_train_mesh_reference.py`` under
    ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and the
    launcher on 4 ranks (``--dist-init file://...``), under one deadline
    that kills them all; meanwhile this process trains every run on one
    process through the port's ``make_train_step``.  Every rank's losses,
    ``grad_norm``, ``lr`` and final parameters equal the one-process
    port's and (on :data:`JAX_RUNS`) JAX's mesh step's: metrics within
    1e-5 relative, every
    parameter within 1e-4 of its leaf's peak, the two leaves that start
    at zero (``qkv_bias``'s K bias, RWKV-6's ``w_lora_B``) at one and
    1e-2 of the summed learning rate, as in
    ``tests/test_torch_substrate.py``.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.sharding as jsh
import torch_train_mesh_worker as W
from repro.configs import ARCHS
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMStream
from repro_torch.launch import sharding as sh
from repro_torch.launch import train as launcher
from repro_torch.models import build_model, params_from_jax
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
from repro_torch.train import make_train_step

pytestmark = pytest.mark.torch_port

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"

#: the fake meshes of the rule checks: ``{axis: extent}``, ``use_fsdp``,
#: ``model_axes``
MESHES = {
    "16x16": ({"data": 16, "model": 16}, True, ("model",)),
    "pod2x16x16": ({"pod": 2, "data": 16, "model": 16}, True, ("model",)),
    "4x2": ({"data": 4, "model": 2}, True, ("model",)),
    "16x16 no fsdp": ({"data": 16, "model": 16}, False, ("model",)),
    "4x2 no fsdp": ({"data": 4, "model": 2}, False, ("model",)),
    "serve kv4 hd4": ({"data": 16, "kv": 4, "hd": 4}, False, ("kv", "hd")),
    "serve kv2 hd2": ({"data": 2, "kv": 2, "hd": 2}, False, ("kv", "hd")),
}


class FakeMesh:
    """The mesh JAX's rules read (``tests/test_sharding.py:25-31``)."""

    def __init__(self, extents):
        self.shape = dict(extents)
        self.axis_names = tuple(extents)


def _names(path) -> list[str]:
    return [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]


def jax_leaves(arch) -> dict[tuple, tuple]:
    """JAX's full-width parameter leaves: ``{path names: shape}``."""
    model = jax_build_model(jax_get_config(arch), remat=False)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    return {tuple(_names(p)): tuple(x.shape) for p, x in flat}


def port_leaves(arch) -> list[tuple[tuple, tuple]]:
    """The port's full-width parameter leaves on ``meta``: ``(path names,
    shape)`` in the port's tree order."""
    p = build_model(get_config(arch), device="meta").init(0)
    out = []
    sh._paths(p, lambda names, x: out.append((names, tuple(x.shape))))
    return out


def jax_leaf_of(cfg, names) -> tuple[tuple, int | None]:
    """The JAX leaf a port leaf comes from, and its index along JAX's
    stacked layer dim (None for a leaf JAX does not stack): the mapping of
    each family's ``params_from_jax``."""
    if names[0] == "blocks":
        li, rest = int(names[1]), tuple(names[2:])
        if cfg.family == "rwkv6":
            return ("blocks",) + rest, li
        m = cfg.moe_every if cfg.family == "moe" else 1
        return ("blocks", f"sub{li % m}") + rest, li // m
    if names[0] == "layers":                     # RG-LRU, flattened
        li, rest = int(names[1]), tuple(names[2:])
        pattern = cfg._full_pattern()
        plen = len(cfg.block_pattern)
        n_super = cfg.num_layers // plen * plen
        n_rec = sum(k == "rglru" for k in cfg.block_pattern)
        if pattern[li] != "rglru":
            return ("supers", "attn") + rest, pattern[:li].count("attn")
        rec_i = pattern[:li].count("rglru")
        if li < n_super:
            return ("supers", f"rec{rec_i % n_rec}") + rest, rec_i // n_rec
        return ("tail",) + rest, li - n_super
    return tuple(names), None


@pytest.fixture(scope="module")
def leaves():
    return {arch: (jax_leaves(arch), port_leaves(arch)) for arch in ARCHS}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(leaves, arch, mesh_name):
    """Every leaf of the full-width config: the port's spec is JAX's with
    the stacked dim dropped; every JAX leaf is reached."""
    extents, fsdp, axes = MESHES[mesh_name]
    cfg = get_config(arch)
    jl, pl = leaves[arch]
    mesh = FakeMesh(extents)
    seen = set()
    for names, shape in pl:
        jpath, idx = jax_leaf_of(cfg, names)
        jshape = jl[jpath]
        seen.add(jpath)
        keys = [type("K", (), {"key": n})() for n in jpath]
        want = tuple(jsh._spec_for(keys, jshape, mesh, fsdp, axes))
        want += (None,) * (len(jshape) - len(want))
        if idx is not None:
            assert jshape[1:] == shape and idx < jshape[0], (names, jshape)
            assert want[0] is None
            want = want[1:]
        else:
            assert jshape == shape, names
        got = sh.spec_for(names, shape, extents, fsdp, axes)
        assert got == want, (names, shape, got, want)
    assert seen == set(jl)


def test_spec_rules_tp_and_fsdp():
    """The cases of ``tests/test_sharding.py::test_spec_rules_tp_and_fsdp``
    on per-layer leaves."""
    m = {"data": 16, "model": 16}
    spec = sh.spec_for
    assert spec(("blocks", "0", "attn", "wq"), (4096, 8192), m) == (
        "data", "model")
    assert spec(("blocks", "0", "attn", "wo"), (8192, 4096), m) == (
        "model", "data")
    assert spec(("embed",), (152064, 8192), m) == ("model", "data")
    assert spec(("blocks", "0", "ln1", "scale"), (4096,), m) == (None,)
    assert spec(("embed",), (49155, 1024), m)[0] is None
    assert spec(("blocks", "0", "mlp", "w_up"), (32, 1024, 512), m)[0] == \
        "model"
    assert spec(("blocks", "0", "attn", "wq"), (4096, 8192), m,
                use_fsdp=False) == (None, "model")
    assert spec(("blocks", "0", "attn", "wk"), (4096, 512),
                {"data": 16, "kv": 4, "hd": 4}, use_fsdp=False,
                model_axes=("kv", "hd")) == (None, ("kv", "hd"))


def batch_tree(cfg, b, s):
    """A batch's leaves as ``ShapeDtypeStruct``s, with the modality's
    extras."""
    f = jax.ShapeDtypeStruct
    tok = (b, s, cfg.num_codebooks) if cfg.family == "audio" else (b, s)
    out = {"tokens": f(tok, jnp.int32), "labels": f(tok, jnp.int32),
           "mask": f((b, s), jnp.float32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = f((b, 4, cfg.d_model), jnp.float32)
        out["positions"] = f((3, b, s), jnp.int32)
    return out


@pytest.fixture
def jax_specs(monkeypatch):
    """JAX's sharding functions with ``NamedSharding`` and
    ``with_sharding_constraint`` patched to hand back the spec."""
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: ("constrained", spec))
    return jsh


@pytest.mark.parametrize("mesh_name", ["16x16", "pod2x16x16", "4x2"])
@pytest.mark.parametrize("arch", ["granite-8b", "qwen2-vl-7b",
                                  "musicgen-large"])
def test_batch_specs_equal_jax(jax_specs, arch, mesh_name):
    extents = MESHES[mesh_name][0]
    tree = batch_tree(jax_get_config(arch), 32, 64)
    want = jax_specs.batch_shardings(tree, FakeMesh(extents))
    for k, x in tree.items():
        got = sh.batch_spec_for((k,), len(x.shape), extents)
        assert got == tuple(want[k]), (k, got, want[k])


@pytest.mark.parametrize("mesh_name", ["16x16", "4x2"])
def test_serve_specs_equal_jax(jax_specs, mesh_name):
    extents = MESHES[mesh_name][0]
    f = jax.ShapeDtypeStruct
    tree = {f"{g}_{i}": f(shape, jnp.float32) for g in (1, 4) for i, shape
            in enumerate(((g, 8), (g, 28, 64, 16, 4, 128),
                          (g, 2, 16, 4, 30), (g,), (g, 3, 5, 7, 2, 6)))}
    tree["scalar"] = f((), jnp.int32)
    want = jax_specs.serve_shardings(tree, FakeMesh(extents))
    for k, x in tree.items():
        got = sh.serve_spec_for(tuple(x.shape), extents)
        assert got == tuple(want[k]), (k, got, want[k])


@pytest.mark.parametrize("sp", [True, False])
@pytest.mark.parametrize("mesh_name", ["16x16", "pod2x16x16", "4x2"])
def test_activation_specs_equal_jax(jax_specs, mesh_name, sp):
    extents = MESHES[mesh_name][0]
    hook = jax_specs.make_shard_hook(FakeMesh(extents),
                                     sequence_parallel=sp)
    for name in ("act_btd", "act_btd_nosp", "logits", "other"):
        for shape in ((8, 64, 32), (8, 30, 32), (8, 64, 4, 49155),
                      (8, 64, 32000), (8, 64), (64,)):
            x = jax.ShapeDtypeStruct(shape, jnp.float32)
            out = hook(x, name)
            want = tuple(out[1]) if isinstance(out, tuple) else None
            got = sh.activation_spec(extents, name, shape,
                                     sequence_parallel=sp)
            assert got == want, (name, shape, got, want)


# ---------------------------------------------------------------------------
# gloo runs
# ---------------------------------------------------------------------------

RANKS = 4
#: seconds every process of the fixture may take, all together: a
#: hang guard, well past what a loaded run of the whole suite takes
DEADLINE_S = 600
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-4
#: the leaves that start at zero (ROADMAP Queue 3): x the summed lr
ZERO_START = {"bk": 1.0, "w_lora_B": 1e-2}
#: the runs JAX's mesh step also trains (one process, with the compression
#: case): every family's single steps on (2, 2), the dense dispatch, and
#: granite-8b's and granite-moe's accumulated steps; the others are held
#: to the one-process port, which ``tests/test_torch_substrate.py`` holds
#: to JAX's step (JAX's compiles take the fixture's time)
JAX_RUNS = [n for n, run in W.RUNS.items() if run["mesh"] == (2, 2) and (
    run["accum"] == 1 or run["arch"] in ("granite-8b",
                                         "granite-moe-1b-a400m"))]
#: the launcher's run on the mesh and off it, then its resume
LAUNCH = ["--arch", "granite-8b", "--reduced", "--device", "cpu",
          "--seq-len", "16", "--global-batch", "8", "--ckpt-every", "2"]
LAUNCH_STEPS = (3, 5)
LAUNCH_RANK = (
    "import json, sys; from repro_torch.launch import train; "
    "h = train.main(sys.argv[2:]); "
    "open(sys.argv[1], 'w').write(json.dumps(h))")


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _start(cmd, env_extra=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "XLA_FLAGS")}
    env.update(PYTHONPATH=f"{SRC}{os.pathsep}{HERE}", OMP_NUM_THREADS="1",
               **(env_extra or {}))
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _launchers(work, steps, tag):
    return {f"launch{tag}_{r}": _start(
        [sys.executable, "-c", LAUNCH_RANK,
         str(work / f"launch{tag}_{r}.json"), *LAUNCH, "--steps", str(steps),
         "--ckpt-dir", str(work / "launch_ckpt"), "--data", "2", "--model",
         "2", "--dist-init", f"file://{work / f'launch_store{tag}'}"],
        {"RANK": str(r), "WORLD_SIZE": str(RANKS)}) for r in range(RANKS)}


def one_process(weights, run):
    """The run on one process through the port's ``make_train_step``:
    (metrics per step, final parameters, final state)."""
    cfg = get_config(run["arch"], reduced=True)
    params = params_from_jax(weights[run["arch"]], cfg, "cpu")
    model = build_model(cfg, device="cpu", use_kernels=False,
                        **run.get("model", {}))
    step = make_train_step(model, AdamWConfig(**W.STEP_OPT),
                           accum_steps=run["accum"])
    stream = SyntheticLMStream(cfg, ShapeConfig("t", W.SEQ, W.BATCH,
                                                "train"))
    opt, metrics = adamw_init(params), []
    for s in range(run["steps"]):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in stream.batch(s).items()}
        params, opt, met = step(params, opt, batch)
        metrics.append({k: float(v) for k, v in met.items()})
    return metrics, params, opt


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("train_mesh")
    weights = {}
    for arch in W.FAMILIES:
        jm = jax_build_model(jax_get_config(arch, reduced=True),
                             use_kernels=False)
        np_params = jax.tree_util.tree_map(np.asarray,
                                           jm.init(jax.random.PRNGKey(0)))
        np.savez(work / f"weights_{arch}.npz", **_flatten(np_params))
        weights[arch] = np_params
    t0 = time.monotonic()
    procs = {"jax": _start(
        [sys.executable, str(HERE / "jax_train_mesh_reference.py"),
         str(work), "mesh", "compress", *JAX_RUNS],
        {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
         "JAX_PLATFORMS": "cpu"})}
    for r in range(RANKS):
        procs[f"rank{r}"] = _start(
            [sys.executable, str(HERE / "torch_train_mesh_worker.py"),
             str(r), str(RANKS), str(work / "store"), str(work)])
    procs.update(_launchers(work, LAUNCH_STEPS[0], 0))
    # the module's own entry point, on one device
    procs["entry"] = _start([sys.executable, "-m", "repro_torch.launch.train",
                             *LAUNCH, "--steps", "1", "--ckpt-dir",
                             str(work / "entry_ckpt")])
    outs = {}

    def finish(names_):
        for name in names_:
            p = procs[name]
            left = DEADLINE_S - (time.monotonic() - t0)
            try:
                outs[name], err = p.communicate(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                pytest.fail(f"{name} did not finish in {DEADLINE_S} s")
            if p.returncode != 0:
                pytest.fail(f"{name} exited {p.returncode}:\n{err[-3000:]}")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # the ranks and JAX hold the cores
    try:
        # this process's share, while the ranks run: one process
        single = {name: one_process(weights, run)
                  for name, run in W.RUNS.items()}
        trainer_ref = one_process(weights, dict(
            arch=W.TRAINER["arch"], accum=1, steps=W.TRAINER["resume_to"]))
        off = [launcher.main([*LAUNCH, "--steps", str(n), "--ckpt-dir",
                              str(work / "launch_off")])
               for n in LAUNCH_STEPS]
        finish([f"launch0_{r}" for r in range(RANKS)])
        procs.update(_launchers(work, LAUNCH_STEPS[1], 1))
        finish(list(procs))
    finally:
        torch.set_num_threads(threads)
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return dict(
        ranks=[json.loads((work / f"rank{r}.json").read_text())
               for r in range(RANKS)],
        rank_arrays=[dict(np.load(work / f"rank{r}.npz"))
                     for r in range(RANKS)],
        jax=json.loads((work / "jax_mesh.json").read_text()),
        jax_arrays=dict(np.load(work / "jax_mesh.npz")),
        jax_compress=json.loads((work / "jax_compress.json").read_text()),
        single=single, trainer_ref=trainer_ref, weights=weights,
        launch=[[json.loads((work / f"launch{t}_{r}.json").read_text())
                 for r in range(RANKS)] for t in range(2)],
        launch_out=[[outs[f"launch{t}_{r}"] for r in range(RANKS)]
                    for t in range(2)],
        off=off, entry=outs["entry"], seconds=time.monotonic() - t0)


def np_local(full: np.ndarray, spec, extents: dict, coord: list) -> np.ndarray:
    """This rank's slice of ``full`` under ``spec`` on a mesh of
    ``extents`` at ``coord`` (JAX's layout: a dim of several axes split
    in their order, the first outermost)."""
    at = dict(zip(extents, coord))
    out = full
    for d, entry in enumerate(spec):
        axes = [] if entry is None else (
            [entry] if isinstance(entry, str) else list(entry))
        n, idx = 1, 0
        for a in axes:
            n *= extents[a]
            idx = idx * extents[a] + at[a]
        step = out.shape[d] // n
        out = np.take(out, range(idx * step, (idx + 1) * step), axis=d)
    return out


def summed_lr(steps: int) -> float:
    cfg = AdamWConfig(**W.STEP_OPT)
    return sum(float(cosine_schedule(torch.tensor(s + 1), cfg))
               for s in range(steps))


def same_metrics(got, want, who):
    assert len(got) == len(want), who
    for s, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), (who, s)
        for k in w:
            assert abs(g[k] - w[k]) <= LOSS_RTOL * abs(w[k]), (who, s, k,
                                                               g[k], w[k])


def same_params(local: dict, want_tree, specs, extents, coord, steps, who):
    lr_sum = summed_lr(steps)
    for name, w in ckpt.leaf_paths(want_tree):
        w = w.numpy() if isinstance(w, torch.Tensor) else w
        got = local[f"p|{name}"]
        want = np_local(w, specs[name], extents, coord)
        assert got.shape == want.shape, (who, name)
        err = float(np.abs(got - want).max()) if got.size else 0.0
        leaf = "w_lora_B" if name.endswith("w_lora_B") else \
            name.rsplit("_", 1)[-1]
        if leaf in ZERO_START:
            assert err <= ZERO_START[leaf] * lr_sum, (who, name, err)
        else:
            peak = float(np.abs(w).max())
            assert err <= PARAM_RTOL * peak, (who, name, err, peak)


def _local_arrays(runs, r, prefix):
    return {k[len(prefix) + 1:]: v for k, v in runs["rank_arrays"][r].items()
            if k.startswith(prefix + "|")}


@pytest.mark.parametrize("name", list(W.RUNS))
def test_mesh_step_equals_one_process_and_jax(runs, name):
    """Every rank's losses, ``grad_norm``, ``lr`` and final parameter
    slices equal the one-process port's and (on (2, 2)) JAX's mesh
    step's; parameters and moments are stored in the declared layouts,
    the batch split as ``batch_shardings`` declares."""
    run = W.RUNS[name]
    cfg = get_config(run["arch"], reduced=True)
    extents = dict(zip(("data", "model"), run["mesh"]))
    want_metrics, want_params, _ = runs["single"][name]
    refs = {"port": (want_metrics, want_params)}
    if name in JAX_RUNS:
        refs["jax"] = (runs["jax"][name], params_from_jax(
            W.unflatten(_Npz(runs["jax_arrays"], name)), cfg, "cpu"))
    for r, res in enumerate(runs["ranks"]):
        got = res["runs"][name]
        assert got["layout_ok"] and got["batch_ok"], (name, r)
        assert got["step"] == run["steps"]
        assert got["comm"]["gathered"] > 0
        local = _local_arrays(runs, r, name)
        for who, (metrics, tree) in refs.items():
            same_metrics(got["metrics"], metrics, f"{name} rank {r} {who}")
            same_params(local, tree, got["specs"], extents, got["coord"],
                        run["steps"], f"{name} rank {r} {who}")


class _Npz:
    """The arrays of one run in the JAX reference's flattened output, as
    ``np.load`` gives them (``.files`` and item access)."""

    def __init__(self, arrays, name):
        self._a = {k.split("|", 1)[1]: v for k, v in arrays.items()
                   if k.split("|", 1)[0] == name}
        self.files = list(self._a)

    def __getitem__(self, key):
        return self._a[key]


def test_moments_are_zero3_slices(runs):
    """Both AdamW moments are stored as the parameters' slices: their
    local shapes are the parameters' on every rank."""
    for r in range(RANKS):
        arr = runs["rank_arrays"][r]
        for key, v in arr.items():
            if "|p|" in key:
                for tag in ("m", "v"):
                    assert arr[key.replace("|p|", f"|{tag}|")].shape == \
                        v.shape, key


def test_trainer_on_the_mesh_trains_and_resumes(runs):
    """``Trainer(mesh=...)``: 3 steps with an async checkpoint at 2 and
    the final one at 3, then a resume at 3 to 4; every step's metrics
    equal the one-process step's, parameters are DTensors."""
    want = runs["trainer_ref"][0]
    for r, res in enumerate(runs["ranks"]):
        tr = res["trainer"]
        assert [h["start"] for h in tr["runs"]] == [0, W.TRAINER["steps"]]
        assert tr["ckpts"] == ["step_2", "step_3", "step_4"]
        hist = [h for run in tr["runs"] for h in run["history"]]
        assert [h["step"] for h in hist] == list(range(4))
        for run in tr["runs"]:
            assert run["dtensor"] == "DTensor"
        same_metrics([{k: v for k, v in h.items() if k != "step"}
                      for h in hist], want, f"trainer rank {r}")


@pytest.mark.parametrize("target", ["4x1", "1x4"])
def test_restore_reshards_bit_for_bit(runs, target):
    """Saved on (2, 2), restored onto (4, 1) and (1, 4): each rank's slices
    are the whole leaves' under the target layouts, bit for bit."""
    cfg = get_config("granite-8b", reduced=True)
    whole = params_from_jax(runs["weights"]["granite-8b"], cfg, "cpu")
    d, m = map(int, target.split("x"))
    extents = {"data": d, "model": m}
    for r, res in enumerate(runs["ranks"]):
        assert res["restore"][target] is True
        coord = [r // m, r % m]
        local = _local_arrays(runs, r, f"restore|{target}")
        for name, w in ckpt.leaf_paths(whole):
            spec = sh.spec_for(_tree_path(whole, name), tuple(w.shape),
                               extents)
            np.testing.assert_array_equal(
                local[name], np_local(w.numpy(), spec, extents, coord))


def _tree_path(tree, name) -> tuple:
    """The path names of the leaf ``ckpt.leaf_paths`` names ``name``."""
    out = []
    sh._paths(tree, lambda names, x: out.append(names))
    for names in out:
        if "_".join(names) == name:
            return names
    raise KeyError(name)


def _np_compress(grads: list[np.ndarray]):
    """The numpy model of ``compressed_psum_tree`` with zero residuals:
    (mean, each rank's residual)."""
    n = np.float32(len(grads))
    qs, scales = [], []
    for g in grads:
        scale = np.maximum(np.abs(g).max(), np.float32(1e-12)) / \
            np.float32(127.0)
        qs.append(np.clip(np.round(g / scale), -127, 127).astype(np.int8))
        scales.append(np.float32(scale))
    qsum = np.sum([q.astype(np.int32) for q in qs], axis=0)
    ssum = np.float32(np.sum(scales, dtype=np.float32)) / n
    mean = qsum.astype(np.float32) * ssum / n
    errs = [g - q.astype(np.float32) * s for g, q, s in zip(grads, qs,
                                                            scales)]
    return mean, errs


def test_compressed_psum_replicated_gives_jax_bytes(runs):
    for r, res in enumerate(runs["ranks"]):
        for k, want in runs["jax_compress"].items():
            got = res["compress"]["replicated"][k]
            for part in ("mean", "err"):
                np.testing.assert_array_equal(
                    np.asarray(got[part], np.float32),
                    np.asarray(want[part], np.float32), err_msg=(r, k, part))


def test_compressed_psum_distinct_matches_numpy(runs):
    for k in ("a", "b"):
        grads = [W.compress_grads(0, r, RANKS, False)[k]
                 for r in range(RANKS)]
        mean, errs = _np_compress(grads)
        for r, res in enumerate(runs["ranks"]):
            got = res["compress"]["distinct"][k]
            np.testing.assert_allclose(np.asarray(got["mean"], np.float32),
                                       mean, rtol=1e-6, atol=0)
            np.testing.assert_array_equal(
                np.asarray(got["err"], np.float32), errs[r])


@pytest.mark.parametrize("case", ["replicated", "distinct"])
def test_error_feedback_unbiased_over_50_steps(runs, case):
    """The bound of ``test_error_feedback_unbiased_over_time``: the
    accumulated all-reduced updates stay within 0.2 of the accumulated
    true mean's peak (+ 0.2) over 50 steps."""
    for res in runs["ranks"]:
        fb = res["compress"][f"feedback_{case}"]
        assert fb["gap"] <= fb["scale"] * 0.2 + 0.2, fb


def test_shard_hook_redistributes_dtensors(runs):
    """On (data 2, model 2) a ``[4, 8, 6]`` DTensor is redistributed to
    JAX's specs: ``act_btd`` (data, model, None), ``act_btd_nosp`` (data,
    None, None), ``logits`` (data, None, model); another name and a plain
    tensor are left as they are."""
    want = {"act_btd": (["Shard(dim=0)", "Shard(dim=1)"], [2, 4, 6]),
            "act_btd_nosp": (["Shard(dim=0)", "Replicate()"], [2, 8, 6]),
            "logits": (["Shard(dim=0)", "Shard(dim=2)"], [2, 8, 3]),
            "other": (["Replicate()", "Replicate()"], [4, 8, 6])}
    for res in runs["ranks"]:
        hook = res["hook"]
        assert hook.pop("plain_same") is True
        for name, (placements, shape) in want.items():
            assert hook[name] == dict(placements=placements, local=shape,
                                      equal=True), name


def test_launcher_on_the_mesh_equals_one_device_and_resumes(runs):
    """``launch/train.py --data 2 --model 2 --dist-init file://...`` on 4
    ranks: every rank's history equals the ``--data 1 --model 1`` run's;
    only rank 0 prints; a rerun with a larger ``--steps`` resumes from the
    checkpoint."""
    for t, steps in enumerate(LAUNCH_STEPS):
        want = runs["off"][t]
        assert want and want[-1]["step"] == steps - 1
        for r in range(RANKS):
            got = runs["launch"][t][r]
            same_metrics(got, want, f"launcher round {t} rank {r}")
        out = runs["launch_out"][t]
        assert "final loss:" in out[0]
        assert all(o == "" for o in out[1:]), out[1:]
    assert "resumed from step 3" in runs["launch_out"][1][0]


def test_launcher_module_entry_point_trains(runs):
    """``python -m repro_torch.launch.train`` runs ``main``."""
    assert "final loss:" in runs["entry"]


def test_launcher_leaves_ranks_out_of_a_smaller_mesh(runs):
    """``--data 1 --model 2`` on the 4 ranks' group: ranks 0 and 1 train
    (rank 0 prints), ranks 2 and 3 say they are idle."""
    out = [res["idle_launch"] for res in runs["ranks"]]
    assert "final loss:" in out[0] and out[1] == ""
    for r in (2, 3):
        assert out[r] == (f"rank {r}: idle, the 2-rank training mesh "
                          "leaves this rank out\n")


def test_fixture_within_its_deadline(runs):
    assert runs["seconds"] < DEADLINE_S

"""The port's serve mesh and sharded kernel dispatch on gloo ranks.

One module fixture starts, all at once, each as its own process:
  * 4 gloo ranks of ``tests/torch_mesh_worker.py`` (a (kv 2, hd 2) mesh:
    both axes split) and 3 more in a world of their own (Hkv 2, D 16
    factor as (kv 2, hd 1) there, so rank 2 is left out of the mesh), each
    rendezvousing through a ``file://`` store in ``tmp_path`` (no TCP port
    to collide between xdist workers), with a 60 s process-group timeout;
  * ``tests/jax_mesh_reference.py`` under
    ``XLA_FLAGS=--xla_force_host_platform_device_count=512``: JAX's
    ``make_serve_mesh`` / ``make_host_serve_mesh`` / ``kv_partition_axes``
    and JAX's own ``*_sharded`` wrappers on a (kv 2, hd 2) mesh.
Meanwhile this process runs the reduced qwen2-7b on one device through
JAX and through the port.  Every process has its own timeout; on one,
all are killed and the fixture fails, so a hung collective fails these
tests instead of stalling the suite.

What is held, each case its own test:
  * the port's factorizations equal JAX's (256- and 512-device serve
    meshes, host meshes of 1-8 devices, every axis degradation);
  * each sharded wrapper on the grid of ``tests/test_kernels_sharded.py``
    and ``tests/test_kv_quant.py::TestInt8Sharded`` (Hkv 2, G 2, D 16):
    every rank's local output equals its slice of the port's
    single-process op (copies bit for bit, attention 2e-5), carries the
    declared placements, and the copies write the local pool in place;
    Hkv 3 and D 15 degrade the kv and hd axes;
  * one case of each wrapper (int8 and degraded ones too) against JAX's
    ``*_sharded`` (2e-5; copies bit for bit);
  * ``TransformerLM(kernel_mesh=...)`` on 4 ranks (reduced qwen2-7b, Hkv
    2, D 14: (kv 2, hd 2)), native and int8: prefill, a continuation, 8
    greedy decode steps and a fused horizon of 4 give the tokens of the
    port's single-process run and of JAX's, logits within
    ``tests/test_torch_model.py``'s tolerances (1e-4; 1e-3 int8), each
    rank's pool slices equal to the single-process pools' (int8 bit for
    bit, f32 within 2.1e-6).
"""

from __future__ import annotations

import copy
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

import torch_mesh_worker as W
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.models import params_from_jax
from repro_torch.models.transformer import TransformerLM
from test_torch_model import perturbed

pytestmark = pytest.mark.torch_port

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"
HKV, G, D = W.GRID_HKV, 2, W.GRID_D
KV_SCALE = 1.0 / TransformerLM.KV_INT8_SCALE
#: seconds every process of the fixture may take, all together: a
#: hang guard, well past what a loaded run of the whole suite takes
DEADLINE_S = 600
#: the (Hkv, D) grid the factorizations are held on: the configs' (8, 128),
#: (4, 128), (32, 64), the reduced qwen2-7b's (2, 14), the kernel grid's
#: (2, 16), and (3, 16), (1, 64), (3, 10) for the degradations and raises
GRID = [(8, 128), (4, 128), (32, 64), (2, 14), (2, 16), (3, 16), (1, 64),
        (3, 10)]
MODEL_LENS = [13, 6, 9]
MODEL_TOL = {"native": 1e-4, "int8": 1e-3}
#: the f32 KV bound of Queue 3 (the port's pools against JAX's)
F32_POOL_TOL = 2.1e-6


# ---------------------------------------------------------------------------
# cases: numpy inputs made from a seed (the JAX grids' shapes)
# ---------------------------------------------------------------------------


def _table(rng, need, max_pages, n_frames):
    frames = rng.permutation(n_frames)
    table = np.full((len(need), max_pages), -1, np.int32)
    fi = 0
    for row, n in enumerate(need):
        table[row, :n] = frames[fi:fi + n]
        fi += n
    return table


def _pools(rng, shape, int8):
    if int8:
        return [rng.integers(-127, 128, size=shape).astype(np.int8)
                for _ in range(2)]
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


def decode_case(page, lens, *, hkv=HKV, g=G, d=D, seed=0, int8=False):
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int32)
    need = [-(-int(n) // page) for n in lens]
    max_pages = max(need) + 1
    n_frames = len(lens) * max_pages + 2
    kp, vp = _pools(rng, (n_frames, page, hkv, d), int8)
    return dict(q=rng.standard_normal((len(lens), hkv, g, d)).astype(
        np.float32), k_pool=kp, v_pool=vp,
        page_table=_table(rng, need, max_pages, n_frames), lens=lens)


def prefill_case(page, starts, chunks, *, hkv=HKV, g=G, d=D, seed=0,
                 int8=False):
    rng = np.random.default_rng(seed)
    starts, chunks = (np.asarray(x, np.int32) for x in (starts, chunks))
    need = [-(-int(t) // page) for t in starts + chunks]
    max_pages = max(need) + int(int8)
    n_frames = len(starts) * max_pages + 3
    kp, vp = _pools(rng, (n_frames, page, hkv, d), int8)
    q = rng.standard_normal((len(starts), int(chunks.max()), hkv, g, d))
    return dict(q=q.astype(np.float32), k_pool=kp, v_pool=vp,
                page_table=_table(rng, need, max_pages, n_frames),
                starts=starts)


def copy_case(page, covers, *, lens=None, starts=None, seed=0, pair=False):
    """``covers`` sizes the page table (the last token a row may touch),
    ``lens`` is what the op sees; every page of a row is mapped."""
    rng = np.random.default_rng(100 + seed)
    covers = np.asarray(covers, np.int32)
    lens = covers if lens is None else np.asarray(lens, np.int32)
    max_pages = -(-int(covers.max()) // page)
    s = (int(lens.max()) if starts is not None else max_pages * page)
    n_frames = len(covers) * max_pages + 3
    out = {}
    for x in ("k", "v") if pair else ("",):
        pre = f"{x}_" if x else ""
        out[pre + "src"] = rng.standard_normal(
            (len(covers), s, HKV, D)).astype(np.float32)
        out[pre + "pool"] = rng.standard_normal(
            (n_frames, page, HKV, D)).astype(np.float32)
    out["page_table"] = _table(rng, [max_pages] * len(covers), max_pages,
                               n_frames)
    if starts is not None:
        out["starts"] = np.asarray(starts, np.int32)
    out["lens"] = lens
    return out


def flash_case(b=2, s=24, seed=9):
    rng = np.random.default_rng(seed)
    return dict(q=rng.standard_normal((b, HKV * G, s, D)).astype(np.float32),
                k=rng.standard_normal((b, HKV, s, D)).astype(np.float32),
                v=rng.standard_normal((b, HKV, s, D)).astype(np.float32))


ORDER = {"copy": W.COPY_ARGS["copy"], "copy_at": W.COPY_ARGS["copy_at"],
         "copy_kv": W.COPY_ARGS["copy_kv"],
         "copy_kv_at": W.COPY_ARGS["copy_kv_at"],
         "decode": ("q", "k_pool", "v_pool", "page_table", "lens"),
         "prefill": ("q", "k_pool", "v_pool", "page_table", "starts"),
         "flash": ("q", "k", "v")}


def build_cases():
    """(cases, inputs): each case ``{id, op, args, kw, rows, jax, w3}``;
    ``rows`` are the valid query rows of a prefill output, ``jax`` marks
    the cases also run through JAX's wrapper, ``w3`` those of the world
    of 3."""
    cases, inputs = [], {}

    def add(cid, op, arrays, kw=None, rows=None, jax_=False, w3=False):
        cases.append(dict(id=cid, op=op, args=list(ORDER[op]), kw=kw or {},
                          rows=rows, jax=jax_, w3=w3))
        for n in ORDER[op]:
            inputs[f"{cid}/{n}"] = arrays[n]

    for page in (4, 8):
        for chunk in (1, 3, 8, 17):
            for start in (0, 5, 16):
                add(f"prefill-p{page}-c{chunk}-s{start}", "prefill",
                    prefill_case(page, [start], [chunk],
                                 seed=page * 100 + chunk + start),
                    dict(page_size=page), rows=[chunk],
                    jax_=(page, chunk, start) == (8, 8, 5))
    add("prefill-batched", "prefill", prefill_case(8, [5, 0, 13], [10, 7, 1],
                                                   seed=11),
        dict(page_size=8), rows=[10, 7, 1], w3=True)
    for lens in ([9, 6], [1, 32, 17], [2, 5]):
        add("decode-" + "-".join(map(str, lens)), "decode",
            decode_case(4, lens, seed=sum(lens)), dict(page_size=4),
            jax_=lens == [9, 6], w3=lens == [9, 6])
    for lens in ([7, 5], [16, 1], [4]):
        add("copy-" + "-".join(map(str, lens)), "copy",
            copy_case(4, lens, seed=sum(lens)), dict(page_size=4),
            jax_=lens == [7, 5], w3=lens == [7, 5])
    for windows in ([(2, 5), (0, 3)], [(13, 3)]):
        starts = [w[0] for w in windows]
        lens = [w[1] for w in windows]
        add("copy_at-" + "-".join(f"{a}+{b}" for a, b in windows), "copy_at",
            copy_case(4, [a + b for a, b in windows], lens=lens,
                      starts=starts, seed=sum(lens)), dict(page_size=4),
            jax_=len(windows) == 2, w3=len(windows) == 2)
    add("copy_kv-7-5", "copy_kv", copy_case(4, [7, 5], seed=21, pair=True),
        dict(page_size=4), jax_=True)
    add("copy_kv_at-2+5-0+3", "copy_kv_at",
        copy_case(4, [7, 3], lens=[5, 3], starts=[2, 0], seed=22, pair=True),
        dict(page_size=4), jax_=True)
    add("flash", "flash", flash_case(), jax_=True, w3=True)
    add("int8-decode", "decode", decode_case(8, [5, 13, 20], seed=2,
                                             int8=True),
        dict(page_size=8, kv_scale=KV_SCALE), jax_=True)
    add("int8-prefill", "prefill",
        prefill_case(4, [2, 6], [9, 5], seed=3, int8=True),
        dict(page_size=4, kv_scale=KV_SCALE), rows=[9, 5], jax_=True)
    # Hkv 3 never divides kv 2; D 15 never divides hd 2
    add("degrade-hkv3", "prefill",
        prefill_case(4, [2], [6], hkv=3, d=2 * D, seed=5),
        dict(page_size=4), rows=[6], jax_=True)
    add("degrade-d15", "decode", decode_case(4, [9, 6], d=15, seed=7),
        dict(page_size=4), jax_=True)
    return cases, inputs


CASES, INPUTS = build_cases()
BY_ID = {c["id"]: c for c in CASES}
W3_IDS = [c["id"] for c in CASES if c["w3"]]
JAX_IDS = [c["id"] for c in CASES if c["jax"]]


# ---------------------------------------------------------------------------
# the processes
# ---------------------------------------------------------------------------


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def jax_serve(jm, jp, vocab):
    """``torch_mesh_worker.serve``'s sequence through the JAX model."""
    m = W.MODEL
    toks, lens, cont, chunks, table = W.model_inputs(vocab, MODEL_LENS)
    st = jm.init_kv_state(len(lens), m["frames"], m["page"], m["max_pages"])
    st = st._replace(page_table=jnp.asarray(table))
    logits, st = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(lens), st)
    out = {"prefill_logits": logits}
    logits, st = jm.prefill_continue(jp, jnp.asarray(cont), st.seq_lens,
                                     jnp.asarray(chunks), st)
    out["continue_logits"] = logits
    tok, steps, step_logits = jnp.argmax(logits, -1).astype(jnp.int32), [], []
    for _ in range(m["steps"]):
        logits, st = jm.decode_step(jp, tok, st)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        steps.append(tok)
        step_logits.append(logits)
    block, st, _ = jm.decode_multi_step(
        jp, tok, st, jnp.asarray(m["steps_left"], jnp.int32),
        jax.random.PRNGKey(0), jnp.float32(1.0), horizon=m["horizon"],
        greedy=True)
    out.update(step_tokens=jnp.stack(steps), step_logits=jnp.stack(
        step_logits), block=block, seq_lens=st.seq_lens, k_pools=st.k_pools,
        v_pools=st.v_pools)
    return {k: np.asarray(v) for k, v in out.items()}


def _start(cmd, env_extra=None):
    env = {**os.environ, "PYTHONPATH": f"{SRC}{os.pathsep}{HERE}",
           "OMP_NUM_THREADS": "1", **(env_extra or {})}
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _write_work(work: pathlib.Path, cases) -> None:
    work.mkdir(parents=True, exist_ok=True)
    (work / "cases.json").write_text(json.dumps(cases))
    np.savez(work / "inputs.npz", **{k: v for k, v in INPUTS.items()
                                      if k.split("/")[0] in
                                      {c["id"] for c in cases}})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("mesh")
    work4, work3 = base / "w4", base / "w3"
    _write_work(work4, CASES)
    _write_work(work3, [c for c in CASES if c["w3"]])
    (work4 / "grid.json").write_text(json.dumps(GRID))
    t0 = time.monotonic()
    procs = {"jax": _start(
        [sys.executable, str(HERE / "jax_mesh_reference.py"), str(work4)],
        {"XLA_FLAGS": "--xla_force_host_platform_device_count=512",
         "JAX_PLATFORMS": "cpu"})}

    def ranks(world, work):
        for r in range(world):
            procs[f"w{world}r{r}"] = _start(
                [sys.executable, str(HERE / "torch_mesh_worker.py"), str(r),
                 str(world), str(work / "store"), str(work)])
    ranks(3, work3)
    # the world of 4 also serves the model: its weights first
    jcfg = jax_get_config("qwen2-7b", reduced=True)
    jm = jax_build_model(jcfg, remat=False)
    np_params = perturbed(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))))
    np.savez(work4 / "weights.npz", **_flatten(np_params))
    (work4 / "model.json").write_text(json.dumps({"lens": MODEL_LENS}))
    ranks(4, work4)
    try:
        # this process's share, while the ranks run: one device each
        cfg = get_config("qwen2-7b", reduced=True)
        tp = params_from_jax(np_params, cfg, "cpu")
        jp = jax.tree_util.tree_map(jnp.asarray, np_params)
        single, jax_out = {}, {}
        for kvd in ("native", "int8"):
            single[kvd] = W.serve(TransformerLM(cfg, device="cpu",
                                                kv_dtype=kvd), tp,
                                  MODEL_LENS, cfg.vocab_size)
            jmk = copy.copy(jm)
            jmk.kv_dtype = kvd
            jax_out[kvd] = jax_serve(jmk, jp, cfg.vocab_size)
        for name, p in procs.items():
            left = DEADLINE_S - (time.monotonic() - t0)
            try:
                _, err = p.communicate(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                pytest.fail(f"{name} did not finish in {DEADLINE_S} s")
            if p.returncode != 0:
                pytest.fail(f"{name} exited {p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return dict(
        w4=[dict(np.load(work4 / f"rank{r}.npz")) for r in range(4)],
        w3=[dict(np.load(work3 / f"rank{r}.npz")) for r in range(3)],
        jax=dict(np.load(work4 / "jax_out.npz")),
        factor=json.loads((work4 / "jax_factor.json").read_text()),
        single=single, jax_model=jax_out,
        seconds=time.monotonic() - t0)


# ---------------------------------------------------------------------------
# the port's single-process ops, and the slices a rank holds
# ---------------------------------------------------------------------------


def single_process(case) -> list[np.ndarray]:
    """The case through the port's unsharded op (full outputs)."""
    a = {n: torch.from_numpy(INPUTS[f"{case['id']}/{n}"].copy())
         for n in case["args"]}
    kw, op = case["kw"], case["op"]

    def merged(t):
        return t.reshape(*t.shape[:2], -1)
    if op in ("copy", "copy_at"):
        extra = (a["starts"],) if op == "copy_at" else ()
        fn = ops.paged_copy_at if extra else ops.paged_copy
        fn(merged(a["src"]), merged(a["pool"]), a["page_table"], *extra,
           a["lens"], **kw)
        return [a["pool"].numpy()]
    if op in ("copy_kv", "copy_kv_at"):
        extra = (a["starts"],) if op == "copy_kv_at" else ()
        fn = ops.paged_copy_kv_at if extra else ops.paged_copy_kv
        fn(merged(a["k_src"]), merged(a["v_src"]), merged(a["k_pool"]),
           merged(a["v_pool"]), a["page_table"], *extra, a["lens"], **kw)
        return [a["k_pool"].numpy(), a["v_pool"].numpy()]
    if op == "decode":
        return [ops.paged_decode_attention(
            a["q"], a["k_pool"], a["v_pool"], a["page_table"], a["lens"],
            **kw).numpy()]
    if op == "prefill":
        return [ops.paged_prefill_attention(
            a["q"], a["k_pool"], a["v_pool"], a["page_table"], a["starts"],
            **kw).numpy()]
    return [ops.flash_attention(a["q"], a["k"], a["v"], causal=True).numpy()]


def declared(case, extents: dict) -> list[int]:
    """The output's placements as ``torch_mesh_worker.placement_dims``
    writes them: per mesh axis (kv, hd) the split tensor dim or -1."""
    arrays = {n: INPUTS[f"{case['id']}/{n}"] for n in case["args"]}
    kv_ax, hd_ax = M.partition_axes(extents, *W.kv_dims(case["op"], arrays))
    dims = W.layout_dims(case["op"])
    out = dims["pool" if "pool" in dims else
               "k_pool" if case["op"].startswith("copy") else "q"]
    return [out.get("kv", -1) if kv_ax else -1,
            out.get("hd", -1) if hd_ax else -1]


def rank_slice(full, coord, extents: dict, dims: list[int]):
    out = full
    for ax, c, d in zip(("kv", "hd"), coord, dims):
        if d >= 0:
            step = full.shape[d] // extents[ax]
            out = np.take(out, range(c * step, (c + 1) * step), axis=d)
    return out


def check_case(case, ranks, want_of, exact: bool):
    """Every rank in the mesh: placements as declared, local output equal
    to its slice of ``want_of(i)`` (bit for bit or 2e-5)."""
    shape = [int(x) for x in ranks[0]["mesh_shape"]]
    extents = dict(zip(("kv", "hd"), shape))
    dims = declared(case, extents)
    seen = 0
    for r, res in enumerate(ranks):
        coord = [int(c) for c in res["coord"]]
        if not coord:
            continue
        seen += 1
        n_out = 2 if case["op"] in ("copy_kv", "copy_kv_at") else 1
        for i in range(n_out):
            key = f"{case['id']}/out{i}"
            assert list(res[f"{case['id']}/placements{i}"]) == dims, (r, i)
            got = res[key]
            want = rank_slice(want_of(i), coord, extents, dims)
            if case["rows"]:
                for row, n in enumerate(case["rows"]):
                    np.testing.assert_allclose(
                        got[row, :n], want[row, :n], rtol=2e-5, atol=2e-5,
                        err_msg=f"rank {r} row {row}")
            elif exact:
                np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
            else:
                np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5,
                                           err_msg=f"rank {r}")
        if case["op"].startswith("copy"):
            assert bool(res[f"{case['id']}/in_place"]), f"rank {r}"
    assert seen == int(np.prod(shape))


# ---------------------------------------------------------------------------
# factorization against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hkv,d", GRID)
def test_serve_mesh_shape_equals_jax(runs, hkv, d):
    for pod in (0, 1):
        for ms in (16, 8, 4, 2):
            want = runs["factor"]["serve"][f"{hkv},{d},{pod},{ms}"]
            if want == "ValueError":
                with pytest.raises(ValueError):
                    M.serve_mesh_shape(hkv, d, multi_pod=bool(pod),
                                       model_size=ms)
                continue
            shape, axes = M.serve_mesh_shape(hkv, d, multi_pod=bool(pod),
                                             model_size=ms)
            assert [list(shape), list(axes)] == want, (pod, ms)


@pytest.mark.parametrize("hkv,d", GRID)
def test_host_serve_mesh_shape_equals_jax(runs, hkv, d):
    for n in range(1, 9):
        assert list(M.host_serve_mesh_shape(hkv, d, n)) == \
            runs["factor"]["host"][f"{hkv},{d},{n}"], n


@pytest.mark.parametrize("hkv,d", GRID)
def test_kv_partition_axes_equals_jax(runs, hkv, d):
    parts = {k: v for k, v in runs["factor"]["partition"].items()
             if k.endswith(f"|{hkv},{d}")}
    assert parts
    for key, want in parts.items():
        extents = {a: int(s) for a, s in
                   (x.split("=") for x in key.split("|")[0].split(","))}
        assert list(M.partition_axes(extents, hkv, d)) == want, key


def test_production_mesh_shapes_equal_jax(runs):
    for pod in (0, 1):
        shape, axes = M.production_mesh_shape(multi_pod=bool(pod))
        assert [list(shape), list(axes)] == \
            runs["factor"]["production"][str(pod)]


def test_make_mesh_without_a_process_group_raises():
    for make in (lambda: M.make_host_serve_mesh(2, 16, device="cpu"),
                 lambda: M.make_serve_mesh(8, 128, device="cpu"),
                 lambda: M.make_production_mesh(device="cpu"),
                 lambda: M.make_host_mesh(device="cpu")):
        with pytest.raises(RuntimeError, match="init_process_group"):
            make()


def test_ranks_build_the_meshes(runs):
    """World 4: (kv 2, hd 2) for the grid and the reduced qwen2-7b, a 1 x 4
    host mesh ('data' its dp and FSDP axis), a 256-rank serve mesh refused;
    world 3: (kv 2, hd 1), rank 2 left out with no coordinate."""
    for r, res in enumerate(runs["w4"]):
        assert list(res["mesh_shape"]) == [2, 2]
        assert list(res["coord"]) == [r // 2, r % 2]
        assert list(res["model_mesh_shape"]) == [2, 2]
        assert list(res["host_mesh"]) == [1, 4]
        assert list(res["dp_fsdp"]) == ["data", "data"]
        assert str(res["too_big"]) == ("a 16x8x2 mesh needs 256 ranks; the "
                                       "process group has 4")
    for r, res in enumerate(runs["w3"]):
        assert list(res["mesh_shape"]) == [2, 1]
        assert list(res["coord"]) == ([r, 0] if r < 2 else [])
    assert runs["seconds"] < DEADLINE_S


# ---------------------------------------------------------------------------
# the wrapper grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cid", [c["id"] for c in CASES])
def test_sharded_wrapper_equals_single_process(runs, cid):
    case = BY_ID[cid]
    want = single_process(case)
    check_case(case, runs["w4"], want.__getitem__,
               exact=case["op"].startswith("copy"))


@pytest.mark.parametrize("cid", [c["id"] for c in CASES])
def test_sharded_wrapper_without_a_mesh_is_the_unsharded_op(cid):
    """``mesh=None`` calls the single-device op on plain tensors (JAX's
    ``mesh is None or mesh.size == 1`` branch); the copies still write
    the given pool in place and return it."""
    case = BY_ID[cid]
    want = single_process(case)
    args = [torch.from_numpy(INPUTS[f"{cid}/{n}"].copy())
            for n in case["args"]]
    got = W.WRAPPERS[case["op"]](*args, mesh=None, **case["kw"])
    if case["op"].startswith("copy"):
        pools = [a for n, a in zip(case["args"], args) if n.endswith("pool")]
        got = got if isinstance(got, tuple) else (got,)
        assert all(g is p for g, p in zip(got, pools))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    else:
        np.testing.assert_array_equal(got.numpy(), want[0])


@pytest.mark.parametrize("cid", W3_IDS)
def test_world_of_three_leaves_a_rank_out(runs, cid):
    case = BY_ID[cid]
    want = single_process(case)
    check_case(case, runs["w3"], want.__getitem__,
               exact=case["op"].startswith("copy"))


@pytest.mark.parametrize("cid", JAX_IDS)
def test_sharded_wrapper_equals_jax(runs, cid):
    case = BY_ID[cid]
    check_case(case, runs["w4"],
               lambda i: runs["jax"][f"{cid}/out{i}"],
               exact=case["op"].startswith("copy"))


def test_sharded_wrappers_refuse_a_wrong_layout(runs):
    """On every rank of each mesh: a pool laid out as q, a plain pool and a
    page table split over the mesh each raise before any work."""
    for res in runs["w4"] + runs["w3"][:2]:
        assert list(res["refusals"]) == ["ValueError", "TypeError",
                                         "ValueError"]


# ---------------------------------------------------------------------------
# the model on the mesh
# ---------------------------------------------------------------------------


def _model(runs, kvd):
    ranks = [{k.split("/", 1)[1]: v for k, v in res.items()
              if k.startswith(f"model_{kvd}/")} for res in runs["w4"]]
    return ranks, runs["single"][kvd], runs["jax_model"][kvd]


@pytest.mark.parametrize("kvd", ["native", "int8"])
def test_mesh_model_tokens_equal_single_process_and_jax(runs, kvd):
    ranks, single, jx = _model(runs, kvd)
    for key in ("step_tokens", "block", "seq_lens"):
        np.testing.assert_array_equal(single[key], jx[key], err_msg=key)
        for r, res in enumerate(ranks):
            np.testing.assert_array_equal(res[key], single[key],
                                          err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("kvd", ["native", "int8"])
def test_mesh_model_logits(runs, kvd):
    ranks, single, jx = _model(runs, kvd)
    tol = MODEL_TOL[kvd]
    for key in ("prefill_logits", "continue_logits", "step_logits"):
        for r, res in enumerate(ranks):
            np.testing.assert_allclose(res[key], jx[key], atol=tol, rtol=tol,
                                       err_msg=f"rank {r} {key} vs JAX")
            np.testing.assert_allclose(res[key], single[key], atol=tol,
                                       rtol=tol, err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("kvd", ["native", "int8"])
def test_mesh_model_pool_slices(runs, kvd):
    """Each rank's [L, P, page, Hkv/2, D/2] slice against the
    single-process pools: int8 bit for bit, f32 within Queue 3's bound."""
    ranks, single, _ = _model(runs, kvd)
    extents = {"kv": 2, "hd": 2}
    for r, res in enumerate(ranks):
        coord = [int(c) for c in runs["w4"][r]["coord"]]
        for key in ("k_pools", "v_pools"):
            want = rank_slice(single[key], coord, extents, [3, 4])
            assert res[key].shape == want.shape
            if kvd == "int8":
                np.testing.assert_array_equal(res[key], want,
                                              err_msg=f"rank {r} {key}")
            else:
                np.testing.assert_allclose(res[key], want, rtol=0,
                                           atol=F32_POOL_TOL,
                                           err_msg=f"rank {r} {key}")

"""One gloo rank of ``tests/test_torch_serve_mesh.py`` (not collected).

    python tests/torch_serve_mesh_worker.py RANK WORLD STORE_FILE WORKDIR

Joins a gloo process group through the file rendezvous ``STORE_FILE``
(timeout 60 s) and serves every scenario of :data:`SCENARIOS` through the
port's ``Engine`` on the reduced qwen2-7b (weights from
``WORKDIR/weights.npz``) on ``make_host_serve_mesh``, a (kv 2, hd 2) mesh
of the 4 ranks; then the launcher in this process with ``--replicas 2``
on the group already started, the engine on the one-rank mesh
``make_host_serve_mesh(1, 1)`` (rank 0 serves, ranks 1-3 are left out),
and the layout checks.  Writes ``WORKDIR/rank{RANK}.json`` (tokens,
counters, switch stats, layouts, refusals, the launcher's output) and
``WORKDIR/rank{RANK}.npz`` (final local pool slices, swap records).

The scenario definitions, the workloads and the engine run are
shared with the test and with ``tests/jax_serve_mesh_reference.py``,
which import this module; its own imports are torch, numpy and the port.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import io
import json
import pathlib
import sys

import numpy as np
import torch

#: ``tests/test_serve_sharded.py``'s configs and workloads: ``serve`` are
#: ``ServeConfig`` fields, ``work`` the arguments of :func:`workload`,
#: ``prefix`` a preloaded 10-token prefix, ``jax`` marks the scenarios
#: JAX's engines also serve (kernels off, mesh and single device)
SCENARIOS = {
    "k1": dict(serve=dict(page_size=4, num_pages=64, max_pages_per_seq=32,
                          max_batch=3, max_horizon=1),
               work=dict(n=3, seed=7, lo=5, hi=10), jax=True),
    "k4": dict(serve=dict(page_size=4, num_pages=64, max_pages_per_seq=32,
                          max_batch=3, max_horizon=4),
               work=dict(n=3, seed=7, lo=5, hi=10), jax=True),
    "temperature": dict(serve=dict(page_size=4, num_pages=64,
                                   max_pages_per_seq=32, max_batch=3,
                                   greedy=False, temperature=0.8),
                        work=dict(n=3, seed=11, lo=5, hi=10)),
    "preempt": dict(serve=dict(page_size=4, num_pages=16,
                               max_pages_per_seq=16, max_batch=3),
                    work=dict(n=7, seed=13), jax=True),
    "fork": dict(serve=dict(page_size=4, num_pages=32, max_pages_per_seq=16,
                            max_batch=3),
                 work=dict(n=5, seed=17, max_new=10, lo=4, hi=10,
                           share=True), prefix=True, jax=True),
    "kernels": dict(serve=dict(page_size=4, num_pages=64,
                               max_pages_per_seq=32, max_batch=3),
                    work=dict(n=3, seed=23, lo=5, hi=10)),
    "ref_path": dict(serve=dict(page_size=4, num_pages=64,
                                max_pages_per_seq=32, max_batch=3,
                                use_ref_path=True),
                     work=dict(n=3, seed=23, lo=5, hi=10)),
    "preempt_int8": dict(serve=dict(page_size=4, num_pages=16,
                                    max_pages_per_seq=16, max_batch=3,
                                    kv_dtype="int8"),
                         work=dict(n=7, seed=13)),
    "preempt_aot": dict(serve=dict(page_size=4, num_pages=16,
                                   max_pages_per_seq=16, max_batch=3,
                                   aot_buckets=(16, 32)),
                        work=dict(n=7, seed=13)),
}
#: the scenarios whose final pools and swap records are kept
KEEP_STATE = ("preempt", "preempt_int8")
#: the launcher's workload, served on the mesh and off it
LAUNCH = ["--device", "cpu", "--requests", "4", "--num-pages", "9",
          "--page-size", "4", "--max-batch", "3", "--prompt-len", "20",
          "--max-new-tokens", "14", "--print-tokens"]


def workload(vocab: int, n: int, seed: int, max_new: int = 12, lo: int = 4,
             hi: int = 14, share: bool = False) -> list[dict]:
    """``tests/test_serve_sharded.py``'s ``workload``, as plain fields."""
    rng = np.random.default_rng(seed)
    return [dict(req_id=i, prompt=rng.integers(
        0, vocab, size=int(rng.integers(lo, hi))).astype(np.int32),
        max_new_tokens=max_new, share_prefix=share) for i in range(n)]


def prefix_tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(5).integers(0, vocab, size=10).astype(
        np.int32)


def run_engine(engine_cls, request_cls, model, params, serve_cfg, reqs, *,
               mesh=None, prefix=None):
    """Serve ``reqs`` on a new engine; returns ``(engine, tokens by id,
    the swap records as spilled)``."""
    eng = engine_cls(model, params, serve_cfg, mesh=mesh)
    records = []
    sw = eng.executor.switcher
    spill = sw.spill_kv

    def keep(seq_id, *a, **kw):
        spill(seq_id, *a, **kw)
        records.append(np.array(sw._swap[seq_id].page_data))
    sw.spill_kv = keep
    if prefix is not None:
        eng.preload_prefix(prefix)
    for r in reqs:
        eng.submit(request_cls(**copy.deepcopy(r)))
    done = eng.run()
    return eng, {i: [int(x) for x in np.ravel(done[i].output)]
                 for i in done}, records


def scenario_run(name, engine_cls, request_cls, config_cls, model, params,
                 vocab, mesh=None):
    sc = SCENARIOS[name]
    prefix = prefix_tokens(vocab) if sc.get("prefix") else None
    return run_engine(engine_cls, request_cls, model, params,
                      config_cls(**sc["serve"]), workload(vocab, **sc["work"]),
                      mesh=mesh, prefix=prefix)


def summary(eng, tokens) -> dict:
    """What the test compares: tokens, every counter, the switch stats."""
    return dict(tokens={str(k): v for k, v in tokens.items()},
                counters=dict(eng.counters.counters),
                switch=dataclasses.asdict(eng.executor.switcher.stats))


def unflatten(flat) -> dict:
    tree: dict = {}
    for key in flat.files:
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    return tree


def raises(fn) -> str:
    """The name of the exception ``fn()`` raises, or ``"none"``."""
    try:
        fn()
    except Exception as e:        # the test compares the name
        return type(e).__name__
    return "none"


def layout_checks(eng) -> dict:
    """``check_sharding_invariants`` on the served engine, then on drifted
    copies of its state: a pool replicated on every rank, a pool with its
    layout but new storage, the page table as a DTensor, a split logits
    tensor.  Each drift is put back after its check."""
    from repro_torch.kernels import ops
    ex = eng.executor
    kv, ptab = ex.kv, ex._ptab
    mesh = ex.mesh
    whole = ops.unshard(kv.k_pools)
    out = {"clean": raises(ex.check_sharding_invariants),
           "pool_layout": [list(getattr(p, "dim", -1) for p in
                                kv.k_pools.placements)],
           "local_shape": list(kv.k_pools.to_local().shape),
           "global_shape": list(kv.k_pools.shape)}
    drifts = {
        "replicated_pool": lambda: kv._replace(k_pools=ops.shard_tensor(
            whole, mesh, ops.placements(mesh, {}))),
        "moved_pool": lambda: kv._replace(v_pools=ops.wrap_local(
            kv.v_pools.to_local().clone(), mesh, kv.v_pools.placements,
            kv.v_pools.shape)),
    }
    for name, drift in drifts.items():
        ex.kv = drift()
        out[name] = raises(ex.check_sharding_invariants)
        ex.kv = kv
    ex._ptab = ops.shard_tensor(ptab, mesh, ops.placements(mesh, {}))
    out["dtensor_page_table"] = raises(ex.check_sharding_invariants)
    ex._ptab = ptab
    split = ops.shard_tensor(torch.zeros(4, 2, 6), mesh,
                             ops.placements(mesh, {"kv": 1}))
    out["split_logits"] = raises(lambda: ex.check_sharding_invariants(
        extra=(("logits", split),)))
    out["after"] = raises(ex.check_sharding_invariants)
    return out


def main(argv: list[str]) -> None:
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve as launcher
    from repro_torch.models import build_model, params_from_jax
    from repro_torch.serve import Engine, ServeConfig, ServeRequest
    rank, world, store, work = (int(argv[0]), int(argv[1]), argv[2],
                                pathlib.Path(argv[3]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        cfg = get_config("qwen2-7b", reduced=True)
        params = params_from_jax(unflatten(np.load(work / "weights.npz")),
                                 cfg, "cpu")
        model = build_model(cfg, device="cpu")
        mesh = M.make_host_serve_mesh(cfg.num_kv_heads, cfg.head_dim,
                                      device="cpu")
        res = {"mesh_shape": list(mesh.mesh.shape),
               "mesh_axes": list(mesh.mesh_dim_names),
               "coord": list(mesh.get_coordinate()), "runs": {}}
        arrays = {}
        for name in SCENARIOS:
            eng, tokens, records = scenario_run(
                name, Engine, ServeRequest, ServeConfig, model, params,
                cfg.vocab_size, mesh=mesh)
            out = summary(eng, tokens)
            step = eng.executor._step_model
            out.update(step_is_twin=step is not model,
                       step_use_kernels=step.use_kernels,
                       step_mesh_is_mesh=step.kernel_mesh is mesh,
                       model_mesh_none=model.kernel_mesh is None,
                       replays=len(eng.executor.replays),
                       is_dtensor=type(eng.kv.k_pools).__name__)
            if name == "preempt":
                res["layout"] = layout_checks(eng)
            if name in KEEP_STATE:
                arrays[f"{name}/k_pools"] = eng.kv.k_pools.to_local().numpy()
                arrays[f"{name}/v_pools"] = eng.kv.v_pools.to_local().numpy()
                for i, r in enumerate(records):
                    arrays[f"{name}/record{i}"] = r
            res["runs"][name] = out
            eng.close()
        # the launcher on the started group: rank 0's stdout
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            launcher.main(LAUNCH + ["--serve-mesh", str(world),
                                    "--replicas", "2"])
        res["launcher_replicas"] = buf.getvalue()
        # a one-rank mesh: rank 0 serves as with no mesh, the rest refuse
        one = M.make_host_serve_mesh(1, 1, device="cpu")
        res["one_size"] = one.size()
        if one.get_coordinate() is None:
            res["one"] = raises(lambda: Engine(
                model, params, ServeConfig(**SCENARIOS["k4"]["serve"]),
                mesh=one))
        else:
            eng, tokens, _ = scenario_run("k4", Engine, ServeRequest,
                                          ServeConfig, model, params,
                                          cfg.vocab_size, mesh=one)
            res["one"] = summary(eng, tokens)
            res["one"]["is_dtensor"] = type(eng.kv.k_pools).__name__
            eng.close()
        (work / f"rank{rank}.json").write_text(json.dumps(res))
        np.savez(work / f"rank{rank}.npz", **arrays)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])

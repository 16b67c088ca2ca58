"""One gloo rank of ``tests/test_torch_mesh.py`` (not collected by pytest).

    python tests/torch_mesh_worker.py RANK WORLD STORE_FILE WORKDIR

Joins a gloo process group through the file rendezvous ``STORE_FILE``
(timeout 60 s), builds the ('kv', 'hd') serve mesh on the CPU, runs every
case of ``WORKDIR/cases.json`` on the inputs of ``WORKDIR/inputs.npz``
through the sharded wrappers of ``repro_torch.kernels.ops``, and, with
``WORKDIR/weights.npz`` present, the reduced qwen2-7b through
``TransformerLM(kernel_mesh=...)``.  Writes ``WORKDIR/rank{RANK}.npz``:
each case's local output, its placements (the sharded tensor dim of each
mesh axis, -1 where replicated) and, for the copies, whether the local
pool kept its storage.  A rank the mesh leaves out records only its
coordinate.  Imports nothing of JAX.
"""

from __future__ import annotations

import datetime
import json
import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.models import params_from_jax
from repro_torch.models.transformer import TransformerLM

#: the wrapper grid's (Hkv, D), as ``tests/test_kernels_sharded.py``'s
GRID_HKV, GRID_D = 2, 16

#: the operands of each copy, in the wrapper's order
COPY_ARGS = {
    "copy": ("src", "pool", "page_table", "lens"),
    "copy_at": ("src", "pool", "page_table", "starts", "lens"),
    "copy_kv": ("k_src", "v_src", "k_pool", "v_pool", "page_table", "lens"),
    "copy_kv_at": ("k_src", "v_src", "k_pool", "v_pool", "page_table",
                   "starts", "lens"),
}
WRAPPERS = {
    "copy": ops.paged_copy_sharded,
    "copy_at": ops.paged_copy_at_sharded,
    "copy_kv": ops.paged_copy_kv_sharded,
    "copy_kv_at": ops.paged_copy_kv_at_sharded,
    "decode": ops.paged_decode_attention_sharded,
    "prefill": ops.paged_prefill_attention_sharded,
    "flash": ops.flash_attention_sharded,
}

#: the model run: page size, pool frames, pages a row, the continuation's
#: chunk lengths, greedy decode steps, and the fused horizon's lanes
MODEL = dict(page=4, frames=40, max_pages=10, chunks=(5, 3, 8), steps=8,
             horizon=4, steps_left=(4, 2, 3))


def layout_dims(op: str) -> dict[str, dict[str, int]]:
    """Per sharded operand, ``{'kv' | 'hd': tensor dim}`` as the wrapper
    declares it (before ``kv_partition_axes`` degrades an axis)."""
    if op in COPY_ARGS:
        return {n: {"kv": 2, "hd": 3} for n in COPY_ARGS[op]
                if n.endswith(("src", "pool"))}
    if op == "flash":
        return {n: {"kv": 1} for n in ("q", "k", "v")}
    pool = {"kv": 2, "hd": 3}
    return {"q": {"kv": 1 if op == "decode" else 2},
            "k_pool": pool, "v_pool": pool}


def kv_dims(op: str, arrays: dict) -> tuple[int, int]:
    """(Hkv, D) of a case, read where the wrapper reads them."""
    if op in COPY_ARGS:
        src = arrays["src" if "src" in arrays else "k_src"]
        return src.shape[2], src.shape[3]
    if op == "flash":
        return arrays["k"].shape[1], arrays["q"].shape[3]
    q = arrays["q"]
    return (q.shape[1], q.shape[3]) if op == "decode" else (q.shape[2],
                                                              q.shape[4])


def layout_of(mesh, op: str, arrays: dict) -> dict:
    """Placements of each sharded operand of a case on ``mesh``."""
    kv_ax, hd_ax = M.kv_partition_axes(mesh, *kv_dims(op, arrays))
    axes = {"kv": kv_ax, "hd": hd_ax}
    return {n: ops.placements(mesh, {axes[a]: d for a, d in dims.items()
                                     if axes[a] is not None})
            for n, dims in layout_dims(op).items()}


def local(t):
    """A DTensor's local slice; a plain tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def placement_dims(t) -> list[int]:
    return [getattr(p, "dim", -1) for p in t.placements]


def run_case(mesh, case: dict, inputs, out: dict) -> None:
    op, cid = case["op"], case["id"]
    arrays = {n: torch.from_numpy(inputs[f"{cid}/{n}"]) for n in case["args"]}
    layout = layout_of(mesh, op, arrays)
    args = [ops.shard_tensor(arrays[n], mesh, layout[n]) if n in layout
            else arrays[n] for n in case["args"]]
    kw = dict(case.get("kw", {}))
    result = WRAPPERS[op](*args, mesh=mesh, **kw)
    if op in COPY_ARGS:
        pools = [a for n, a in zip(case["args"], args) if n.endswith("pool")]
        ptrs = [p.to_local().data_ptr() for p in pools]
        got = result if isinstance(result, tuple) else (result,)
        out[f"{cid}/in_place"] = np.asarray(
            all(g is p for g, p in zip(got, pools))
            and ptrs == [p.to_local().data_ptr() for p in got])
        for i, p in enumerate(got):
            out[f"{cid}/out{i}"] = p.to_local().numpy()
            out[f"{cid}/placements{i}"] = np.asarray(placement_dims(p))
    else:
        out[f"{cid}/out0"] = result.to_local().numpy()
        out[f"{cid}/placements0"] = np.asarray(placement_dims(result))


def refusals(mesh) -> list[str]:
    """The exception each misuse raises: a pool with the q layout, a
    plain tensor where a DTensor is declared, a split page table."""
    q = torch.zeros(2, GRID_HKV, 2, GRID_D)
    pool = torch.zeros(6, 4, GRID_HKV, GRID_D)
    table = torch.zeros(2, 2, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    q_l = ops.placements(mesh, {"kv": 1})
    p_l = ops.placements(mesh, {"kv": 2, "hd": 3})
    cases = [
        (ops.shard_tensor(q, mesh, q_l), ops.shard_tensor(pool, mesh, q_l),
         table),
        (ops.shard_tensor(q, mesh, q_l), pool, table),
        (ops.shard_tensor(q, mesh, q_l), ops.shard_tensor(pool, mesh, p_l),
         ops.shard_tensor(table, mesh, ops.placements(mesh, {"kv": 0}))),
    ]
    got = []
    for qq, pp, tt in cases:
        try:
            ops.paged_decode_attention_sharded(qq, pp, pp, tt, lens,
                                               page_size=4, mesh=mesh)
            got.append("none")
        except (TypeError, ValueError) as e:
            got.append(type(e).__name__)
    return got


def unflatten(flat) -> dict:
    tree: dict = {}
    for key in flat.files:
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    return tree


def model_inputs(vocab: int, lens, seed: int = 3):
    """Padded prompts, the continuation's chunks and a page table of
    distinct frames (the pool's last frame stays the decode scratch)."""
    m = MODEL
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int32)
    s = -(-int(lens.max()) // m["page"]) * m["page"]
    toks = np.zeros((len(lens), s), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, vocab, n)
    chunks = np.asarray(m["chunks"], np.int32)
    cont = np.zeros((len(lens), int(chunks.max())), np.int32)
    for i, n in enumerate(chunks):
        cont[i, :n] = rng.integers(0, vocab, n)
    perm = rng.permutation(m["frames"] - 1)
    table = np.full((len(lens), m["max_pages"]), -1, np.int32)
    for i in range(len(lens)):
        table[i] = perm[i * m["max_pages"]:(i + 1) * m["max_pages"]]
    return toks, lens, cont, chunks, table


def serve(model, params, lens, vocab: int) -> dict:
    """prefill -> prefill_continue -> greedy decode_steps ->
    decode_multi_step; logits, tokens and the final pools (this rank's
    slice on a mesh)."""
    m = MODEL
    toks, lens, cont, chunks, table = map(torch.from_numpy,
                                          model_inputs(vocab, lens))
    st = model.init_kv_state(len(lens), m["frames"], m["page"],
                             m["max_pages"])
    st = st._replace(page_table=table)
    logits, st = model.prefill(params, toks, lens, st)
    out = {"prefill_logits": logits}
    logits, st = model.prefill_continue(params, cont, st.seq_lens, chunks, st)
    out["continue_logits"] = logits
    tok, steps, step_logits = logits.argmax(-1).to(torch.int32), [], []
    for _ in range(m["steps"]):
        logits, st = model.decode_step(params, tok, st)
        tok = logits.argmax(-1).to(torch.int32)
        steps.append(tok)
        step_logits.append(logits)
    block, st = model.decode_multi_step(
        params, tok, st, torch.tensor(m["steps_left"], dtype=torch.int32),
        None, 1.0, horizon=m["horizon"], greedy=True)
    out.update(step_tokens=torch.stack(steps),
               step_logits=torch.stack(step_logits), block=block,
               seq_lens=st.seq_lens,
               k_pools=local(st.k_pools), v_pools=local(st.v_pools))
    return {k: v.numpy() for k, v in out.items()}


def main(argv: list[str]) -> None:
    rank, world, store, work = (int(argv[0]), int(argv[1]), argv[2],
                                pathlib.Path(argv[3]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        out: dict = {}
        mesh = M.make_host_serve_mesh(GRID_HKV, GRID_D, device="cpu")
        coord = mesh.get_coordinate()
        out["mesh_shape"] = np.asarray(mesh.mesh.shape)
        out["coord"] = np.asarray(coord if coord is not None else [])
        host = M.make_host_mesh(1, world, device="cpu")
        out["host_mesh"] = np.asarray(host.mesh.shape)
        out["dp_fsdp"] = np.asarray([",".join(M.dp_axes(host)),
                                     str(M.fsdp_axis(host))])
        try:                       # 256 ranks asked of a smaller group
            M.make_serve_mesh(8, 128, device="cpu")
            out["too_big"] = np.asarray("none")
        except ValueError as e:
            out["too_big"] = np.asarray(str(e))
        if coord is not None:
            inputs = np.load(work / "inputs.npz")
            for case in json.loads((work / "cases.json").read_text()):
                run_case(mesh, case, inputs, out)
            out["refusals"] = np.asarray(refusals(mesh))
        weights = work / "weights.npz"
        if weights.exists():
            cfg = get_config("qwen2-7b", reduced=True)
            mmesh = M.make_host_serve_mesh(cfg.num_kv_heads, cfg.head_dim,
                                           device="cpu")
            out["model_mesh_shape"] = np.asarray(mmesh.mesh.shape)
            params = params_from_jax(unflatten(np.load(weights)), cfg, "cpu")
            lens = json.loads((work / "model.json").read_text())["lens"]
            for kvd in ("native", "int8"):
                model = TransformerLM(cfg, device="cpu", kv_dtype=kvd,
                                      kernel_mesh=mmesh)
                for k, v in serve(model, params, lens,
                                  cfg.vocab_size).items():
                    out[f"model_{kvd}/{k}"] = v
        np.savez(work / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])

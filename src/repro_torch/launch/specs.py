"""Dry-run case builders: ``meta`` inputs and the step functions of the
port (port of ``src/repro/launch/specs.py``).

One case per (architecture x input shape x mesh).  Nothing is allocated:
parameters come from ``model.init`` on ``meta`` (``layers.generator``
draws shapes only, JAX's ``jax.eval_shape``), batches and serving state
are ``meta`` tensors (:func:`sds`, JAX's ``ShapeDtypeStruct``), laid out
on the mesh as ``DTensor``s with JAX's specs, and :meth:`DryRunCase.run`
executes the step on them; nothing is lowered.  On a fake process group
(``launch/dryrun.py``) the collectives send nothing.

Train cases are the port's mesh train step (``make_train_step(
grad_shardings=...)``) on parameters and AdamW moments in
``launch/sharding.py``'s layouts, as JAX's ``specs.py:131-168``.

Serving topology (JAX's): serve trees carry a leading data-group axis
``G`` (the data axes' size when the global batch divides it, else 1),
split over the data axes.  Each group owns its own page pool and page
table.  JAX runs the groups by ``jax.vmap`` over G; here each rank runs
its own group: its slice of every ``[G, ...]`` argument (a group of one)
on the ('kv', 'hd') view of the mesh's model axes.  The divergences of
form, all the port's own serve path:

  * the weights are whole on every rank (the port's serve mesh replicates
    them; JAX splits them over the model axes);
  * the GQA families run ``TransformerLM(kernel_mesh=view)``: the pools
    stay split over (kv, hd) and the serve wrappers gather K/V over 'hd';
    ``serve_mode="flat"`` splits the pools' head_dim over 'model', viewed
    as (kv 1, hd 16);
  * RWKV-6 and RG-LRU have no sharded serve path: their state is gathered
    whole within the group, the step runs on whole tensors and its state
    is sliced back to the declared layout (the train step's convention;
    the collective bytes show the cost).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import dp_axes, mesh_extents
from repro_torch.launch.sharding import (NamedSharding, batch_shardings,
                                         make_shard_hook, param_shardings,
                                         shard_tree, spec_placements)
from repro_torch.models import (HybridState, PagedKVState, RecurrentState,
                                build_model)
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.rglru import CONV_WIDTH
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import make_train_step

PAGE_SIZE = 16
N_VIS = 256  # stub vision prefix length


def sds(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype`` (JAX's
    ``jax.ShapeDtypeStruct``)."""
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


@dataclasses.dataclass
class DryRunCase:
    arch: str
    shape: str
    kind: str                       # train | prefill | decode
    fn: Callable                    # the step, run on ``args``
    args: tuple                     # meta tensors / DTensors, global shapes
    model_flops_per_step: float     # 6·N·D (train) / 2·N per token (serve)

    def run(self):
        return self.fn(*self.args)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _dtype(cfg: ModelConfig):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg.param_dtype]


def _group(mesh, global_batch: int) -> tuple[int, int, tuple]:
    """(G, per-group batch, group axes) for serving trees.

    Groups span (pod x data) so multi-pod serving shards the KV pools over
    both axes; falls back to data-only, then to a single replicated group.
    """
    ext = mesh_extents(mesh)
    for axes in (("pod", "data"), ("data",)):
        if not all(a in ext for a in axes):
            continue
        n = 1
        for a in axes:
            n *= ext[a]
        if global_batch % n == 0 and global_batch >= n:
            return n, global_batch // n, axes
    return 1, global_batch, ()


def skip_reason(arch: str, shape_name: str) -> str | None:
    """DESIGN.md §4: long_500k only for sub-quadratic archs."""
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return ("pure full-attention arch: long_500k requires sub-quadratic "
                "attention (DESIGN.md §4)")
    return None


def _on_mesh(x: torch.Tensor, mesh, spec: tuple) -> torch.Tensor:
    """The meta tensor ``x`` as a DTensor under ``spec`` on ``mesh``."""
    return ops.shard_tensor(x, mesh, spec_placements(mesh, spec))


# ---------------------------------------------------------------------------
# train case
# ---------------------------------------------------------------------------


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "audio" and cfg.num_codebooks > 1:
        return {
            "tokens": sds((b, s, cfg.num_codebooks), torch.int32),
            "labels": sds((b, s, cfg.num_codebooks), torch.int32),
            "mask": sds((b, s), torch.float32),
        }
    batch = {
        "tokens": sds((b, s), torch.int32),
        "labels": sds((b, s), torch.int32),
        "mask": sds((b, s), torch.float32),
    }
    if cfg.family == "vlm":
        batch["positions"] = sds((3, b, s), torch.int32)
        batch["vision_embeds"] = sds((b, N_VIS, cfg.d_model), _dtype(cfg))
    return batch


VARIANTS: dict[str, dict] = {
    # §Perf iteration variants (EXPERIMENTS.md): model-construction kwargs
    "wkv_chunked": {"tm_impl": "chunked_matmul"},       # cell C
    "remat_dots": {"remat_policy": "dots"},             # cell B
    "kv_int8": {"kv_dtype": "int8"},                    # cell A
}


def train_case(cfg: ModelConfig, shape: ShapeConfig, mesh,
               **model_kwargs) -> DryRunCase:
    """The mesh train step of ``cfg`` at ``shape`` on ``mesh``: the model
    on ``meta`` (``use_kernels=False``, ``remat=True``, the shard hook,
    ``model_kwargs``), parameters and AdamW moments in their layouts, the
    batch split over the data-parallel axes."""
    model = build_model(cfg, device="meta", use_kernels=False,
                        **{"remat": True, **model_kwargs},
                        shard=make_shard_hook(mesh))
    # 100B+-class models: bf16 moments (halves optimizer memory; DESIGN §3)
    moments = "bfloat16" if cfg.param_count() > 100e9 else "float32"
    opt_cfg = AdamWConfig(moment_dtype=moments)
    params = model.init(0)
    p_sh = param_shardings(params, mesh)
    params = shard_tree(params, p_sh)
    opt = adamw_init(params, opt_cfg.moment_dtype)
    batch = train_batch_specs(cfg, shape)
    batch = shard_tree(batch, batch_shardings(batch, mesh))
    step = make_train_step(model, opt_cfg, donate=True, grad_shardings=p_sh)
    return DryRunCase(
        arch=cfg.name, shape=shape.name, kind="train",
        fn=step, args=(params, opt, batch),
        model_flops_per_step=6.0 * cfg.active_param_count()
        * shape.global_batch * shape.seq_len,
    )


def build_train_case(arch: str, shape_name: str, mesh,
                     variant: str | None = None) -> DryRunCase:
    return train_case(get_config(arch), SHAPES[shape_name], mesh,
                      **(VARIANTS.get(variant, {}) if variant else {}))


# ---------------------------------------------------------------------------
# serve cases
# ---------------------------------------------------------------------------


def _paged_state_specs(cfg: ModelConfig, g: int, b: int, seq_len: int,
                       frames_per_group: int, max_pages: int,
                       kv_dtype=None) -> PagedKVState:
    dt = kv_dtype if kv_dtype is not None else _dtype(cfg)
    shape = (g, cfg.num_layers, frames_per_group, PAGE_SIZE,
             cfg.num_kv_heads, cfg.head_dim)
    return PagedKVState(
        k_pools=sds(shape, dt),
        v_pools=sds(shape, dt),
        page_table=sds((g, b, max_pages), torch.int32),
        seq_lens=sds((g, b), torch.int32),
    )


def executor_state_shardings(mesh, num_kv_heads: int, head_dim: int) -> dict:
    """DTensor placements of the :class:`repro_torch.serve.executor.Executor`'s
    persistent state on a ('kv', 'hd') mesh.

    ``"pool"``: the pools ``[L, P, page, Hkv, hd]`` split over (kv, hd) on
    dims 3 and 4, each axis degrading to ``Replicate()`` where its extent
    does not divide the dim; ``"replicated"``: the layout of the page table
    and of every scalar-plane operand and output (tokens, lengths, logits,
    the sampled block), which every rank reads whole.

    Built on ``ops.kv_layout`` / ``ops.placements``, which the sharded
    wrappers read too (through ``launch.mesh.kv_partition_axes``), so the
    executor's layout and the one each kernel dispatch checks cannot
    disagree.
    """
    return {
        "pool": ops.kv_layout(mesh, num_kv_heads, head_dim, 3, 4),
        "replicated": ops.placements(mesh, {}),
    }


def _serve_view(mesh, serve_mode: str):
    """The ('kv', 'hd') mesh a rank's group runs on: the serve mesh's own
    (kv, hd) axes, or (``"flat"``) the production mesh's 'model' axis
    viewed as (kv 1, hd M) over the same ranks."""
    if serve_mode == "2d":
        return mesh["kv", "hd"]
    from torch.distributed.device_mesh import DeviceMesh
    names = tuple(mesh.mesh_dim_names)
    shape = tuple(mesh.mesh.shape)
    grid = mesh.mesh.reshape(shape[:-1] + (1, shape[-1]))
    return DeviceMesh(mesh.device_type, grid,
                      mesh_dim_names=names[:-1] + ("kv", "hd"))["kv", "hd"]


def _group_whole(t: torch.Tensor) -> torch.Tensor:
    """A ``[G, ...]`` DTensor's group on this rank, whole: its slices over
    the model axes gathered (one all-gather an axis that splits it) and
    the group dim dropped."""
    from torch.distributed.tensor import Shard
    mesh, local = t.device_mesh, t.to_local()
    dps = dp_axes(mesh)
    for name, p in zip(mesh.mesh_dim_names, t.placements):
        if isinstance(p, Shard) and name not in dps:
            local = ops._gather(local, mesh, name, p.dim)
    return local[0]


def _regroup(x: torch.Tensor, like: NamedSharding) -> torch.Tensor:
    """A group's whole tensor ``x`` as the ``[G, ...]`` DTensor of
    ``like``'s layout: this rank's slice over the model axes, with no
    communication."""
    from torch.distributed.tensor import Replicate
    mesh = like.mesh
    pl = like.placements
    dps = dp_axes(mesh)
    inner = tuple(Replicate() if n in dps else p
                  for n, p in zip(mesh.mesh_dim_names, pl))
    local = ops.local_slice(x[None], mesh, inner)
    g = 1
    for n, p in zip(mesh.mesh_dim_names, pl):
        if n in dps and not isinstance(p, Replicate):
            g *= mesh.size(mesh.mesh_dim_names.index(n))
    return ops.wrap_local(local, mesh, pl, (g,) + tuple(x.shape))


def _serve_fn(model, cfg: ModelConfig, is_decode: bool, view, specs: dict):
    """The step of one serve case: each rank runs its group (JAX's
    ``jax.vmap`` over G) and returns ``(logits, state)`` as ``[G, ...]``
    DTensors in the declared layouts (``specs``: the spec of each state
    field and of the logits).  The GQA families' pools go to the model as
    DTensors on ``view``; every other leaf is gathered whole."""
    paged = cfg.family not in ("rwkv6", "hybrid_rglru")

    def localize(state):
        fields = {}
        for name, t in state._asdict().items():
            if paged and name in ("k_pools", "v_pools"):
                layout = ops.kv_layout(view, cfg.num_kv_heads, cfg.head_dim,
                                       3, 4)
                fields[name] = ops.wrap_local(t.to_local()[0], view, layout,
                                              tuple(t.shape[1:]))
            else:
                fields[name] = _group_whole(t)
        return type(state)(**fields)

    def regroup(state, out_state, logits):
        fields = {}
        for name, t in state._asdict().items():
            new = getattr(out_state, name)
            if paged and name in ("k_pools", "v_pools"):
                fields[name] = t              # written in place
            else:
                fields[name] = _regroup(new, NamedSharding(t.device_mesh,
                                                           specs[name]))
        mesh = state.seq_lens.device_mesh
        return (_regroup(logits, NamedSharding(mesh, specs["logits"])),
                type(state)(**fields))

    if is_decode:
        def step(params, tokens, state):
            logits, new = model.decode_step(params, _group_whole(tokens),
                                            localize(state))
            return regroup(state, new, logits)
    else:
        def step(params, tokens, prompt_lens, state, *vision):
            logits, new = model.prefill(
                params, _group_whole(tokens), _group_whole(prompt_lens),
                localize(state), *(_group_whole(v) for v in vision))
            return regroup(state, new, logits)
    return step


def build_serve_case(arch: str, shape_name: str, mesh,
                     serve_mode: str = "2d",
                     variant: str | None = None) -> DryRunCase:
    """Serve cell on either the flat production mesh (baseline: the model
    axis cannot co-shard KV heads and head_dim, so the pools split on
    head_dim only) or the 2-D ('kv','hd') serving view (default)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    model = build_model(cfg, device="meta", use_kernels=False, remat=False,
                        **(VARIANTS.get(variant, {}) if variant else {}))
    params = model.init(0)
    model_axes = ("kv", "hd") if serve_mode == "2d" else ("model",)
    ext = mesh_extents(mesh)
    g, b, gaxes = _group(mesh, shape.global_batch)
    dax = (gaxes if len(gaxes) > 1 else gaxes[0]) if g > 1 else None
    kv_ax, hd_ax = (model_axes if len(model_axes) == 2
                    else (None, model_axes[0]))
    s = shape.seq_len
    dt = _dtype(cfg)
    is_decode = shape.kind == "decode"
    max_pages = -(-(s + (1 if is_decode else 0)) // PAGE_SIZE)

    tok_tail = (cfg.num_codebooks,) if (
        cfg.family == "audio" and cfg.num_codebooks > 1
    ) else ()

    def ok(dim: int, *axes) -> Any:
        """axes if the dim divides their product, else replicated"""
        prod = 1
        for a in axes:
            if a is not None:
                prod *= ext[a]
        axes = tuple(a for a in axes if a is not None)
        if not axes or dim % prod:
            return None
        return axes if len(axes) > 1 else axes[0]

    if cfg.family == "rwkv6":
        h, n = cfg.num_rwkv_heads, cfg.rwkv_head_size
        state = RecurrentState(
            tm_shift=sds((g, cfg.num_layers, b, cfg.d_model), dt),
            cm_shift=sds((g, cfg.num_layers, b, cfg.d_model), dt),
            wkv=sds((g, cfg.num_layers, b, h, n, n), torch.float32),
            seq_lens=sds((g, b), torch.int32),
        )
        shift = (dax, None, None, ok(cfg.d_model, kv_ax, hd_ax))
        st_spec = RecurrentState(
            tm_shift=shift, cm_shift=shift,
            wkv=(dax, None, None, ok(h, kv_ax, hd_ax), None, None),
            seq_lens=(dax, None),
        )
    elif cfg.family == "hybrid_rglru":
        # window-bounded KV: only ceil(window/page)+2 frames live per seq
        # during decode; prefill writes the full prompt (engine frees after)
        win_pages = -(-cfg.local_window // PAGE_SIZE) + 2
        frames = (b * (max_pages if shape.kind == "prefill" else win_pages)
                  + 1)
        r = cfg.rglru_dim or cfg.d_model
        pool_shape = (g, model.n_att, frames, PAGE_SIZE, cfg.num_kv_heads,
                      cfg.head_dim)
        pool = (dax, None, None, None, ok(cfg.num_kv_heads, kv_ax),
                ok(cfg.head_dim, hd_ax))
        state = HybridState(
            rg_h=sds((g, model.n_rec, b, r), torch.float32),
            conv_buf=sds((g, model.n_rec, b, CONV_WIDTH - 1, r), dt),
            k_pools=sds(pool_shape, dt), v_pools=sds(pool_shape, dt),
            page_table=sds((g, b, max_pages), torch.int32),
            seq_lens=sds((g, b), torch.int32),
        )
        st_spec = HybridState(
            rg_h=(dax, None, None, ok(r, kv_ax, hd_ax)),
            conv_buf=(dax, None, None, None, ok(r, kv_ax, hd_ax)),
            k_pools=pool, v_pools=pool,
            page_table=(dax, None, None),
            seq_lens=(dax, None),
        )
    else:
        frames = b * max_pages + 1
        state = _paged_state_specs(
            cfg, g, b, s, frames, max_pages,
            kv_dtype=torch.int8 if getattr(model, "kv_dtype", "native")
            == "int8" else None,
        )
        pool = (dax, None, None, None, ok(cfg.num_kv_heads, kv_ax),
                ok(cfg.head_dim, hd_ax))
        st_spec = PagedKVState(
            k_pools=pool, v_pools=pool,
            page_table=(dax, None, None),
            seq_lens=(dax, None),
        )
    state = type(state)(*(_on_mesh(x, mesh, sp)
                          for x, sp in zip(state, st_spec)))
    tok = _on_mesh(sds((g, b) + (() if is_decode else (s,)) + tok_tail,
                       torch.int32), mesh,
                   (dax,) + (None,) * ((0 if is_decode else 1)
                                       + len(tok_tail)))
    logits_spec = (dax,) + (None,) * (1 + len(tok_tail) + 1)
    specs = {**st_spec._asdict(), "logits": logits_spec}
    view = _serve_view(mesh, serve_mode)
    if cfg.family not in ("rwkv6", "hybrid_rglru"):
        model.kernel_mesh = view
    fn = _serve_fn(model, cfg, is_decode, view, specs)
    if is_decode:
        args = (params, tok, state)
    else:
        lens = _on_mesh(sds((g, b), torch.int32), mesh, (dax, None))
        args = (params, tok, lens, state)
        if cfg.family == "vlm":
            args += (_on_mesh(sds((g, b, N_VIS, cfg.d_model), dt), mesh,
                              (dax, None, None, None)),)
    tokens_per_step = (shape.global_batch if is_decode
                       else shape.global_batch * s)
    return DryRunCase(
        arch=arch, shape=shape_name, kind=shape.kind,
        fn=fn, args=args,
        model_flops_per_step=2.0 * cfg.active_param_count() * tokens_per_step,
    )


def build_case(arch: str, shape_name: str, mesh,
               serve_mode: str = "2d",
               variant: str | None = None) -> DryRunCase:
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return build_train_case(arch, shape_name, mesh, variant)
    return build_serve_case(arch, shape_name, mesh, serve_mode, variant)

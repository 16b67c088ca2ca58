"""Device-resident serving executor — the Ara2 data plane of the split.

Port of ``src/repro/serve/executor.py``.  Everything that
touches a device tensor lives here: the paged KV pools, a *persistent
device page table* (the satp analogue, updated incrementally from
``VirtualMemory.drain_dirty_rows()`` deltas — never re-uploaded
wholesale), and the prefill / decode steps, which update the KV pools in
place.

  * page-table updates are delta-only (``ptab_rows_uploaded`` counter);
  * spill/restore move only the victim sequence's pages
    (``ContextSwitcher.spill_kv``/``restore_kv``);
  * inactive decode lanes are masked on the device from a [B] bool mask,
    not by rewriting table rows on the host;
  * decode runs in fused K-step horizons (``decode_multi``): K chained
    ``decode_step``s with on-device sampling and per-lane retire masking,
    then ONE host transfer of the ``[K, B]`` token block (``[K, B, C]``
    for audio's C codebooks: every token buffer carries the model's token
    shape), so the host round-trip and the page-table delta sync are paid
    once per horizon (``host_syncs`` / ``decode_horizon`` counters);
  * compiled serve programs, the counterpart of JAX's jitted steps and
    AOT executables: each decode horizon on the scheduler's ladder, the
    K=1 step and, with ``ServeConfig.aot_buckets``, a prefill and a
    continuation per bucket are :class:`StepProgram` objects — functions of
    static input buffers over the persistent pools, page table and
    weights.  On the card each is captured as a CUDA graph when the
    executor is built and replayed per step; on the CPU it runs eagerly
    over the same buffers.  :func:`disable_graphs` (the port's
    ``jax.disable_jit``) runs every step eagerly instead;
  * forked admissions (``share_prefix`` forks of the preloaded prefix,
    radix-cache hits, the re-prefilled tail of a partial restore) run as
    ONE batched continuation prefill per step (``admit_forked_batch``):
    copy-on-write tail pages in one indexed assignment, then
    ``TransformerLM.prefill_continue`` with a per-row start offset;
  * restore re-shares pinned-prefix frames by refcount and may re-map
    only a leading part of the record (partial restore);
  * swap records are portable (``export_swap``/``import_swap``): host
    bytes in the pool's storage dtype that another replica's executor
    adopts and restores into its own pools in place, so a router can
    migrate a starved victim;
  * every compute step is tallied as ``kernel_dispatches`` (the kernel
    wrappers) or ``ref_path_dispatches`` (the explicit plain-version hatch,
    ``ServeConfig.use_ref_path``);
  * with a ('kv', 'hd') serve mesh of more than one rank (``Executor(...,
    mesh=...)``, one executor a rank, every rank driving the same
    schedule) the KV pools are DTensors split over (kv, hd)
    (``launch.specs.executor_state_shardings``), and the page table,
    tokens, lengths, logits and sampled blocks are plain tensors, the
    same on every rank.  The step model is a twin bound to the mesh
    (:func:`_mesh_kernel_model`), so the five serve kernels run on each
    rank's pool slice through ``ops.*_sharded``; spill gathers a victim's
    whole record on every rank, restore and copy-on-write copies write
    the local slices in place, and :meth:`Executor.check_sharding_invariants`
    checks the layout after every mutation.  The steps run eagerly on
    such a mesh, never as CUDA graphs: the gloo collectives inside them
    synchronize with the host and cannot be captured.  That is decided
    when the executor is built, from the mesh; it is no fallback from a
    failed capture.  A mesh of one rank is served as no mesh.

AOT buckets take 1-D token prompts only, so an audio model with
``aot_buckets`` is refused when the executor is built (the JAX engine
fails there too, while it compiles its bucket programs).
"""

from __future__ import annotations

import contextlib
import copy
import functools
import gc
from typing import Any

import numpy as np
import torch

from repro_torch.core import (
    ContextSwitcher,
    CostModel,
    INVALID_PAGE,
    PerfCounters,
    VirtualMemory,
)
from repro_torch.kernels import ops
from repro_torch.kernels.paged_prefill_attention import (
    pages_touched,
    prefill_route_rule,
    query_block,
)
from repro_torch.launch.specs import executor_state_shardings
from repro_torch.models.transformer import PagedKVState, TransformerLM, sample
from repro_torch.serve.scheduler import DecodePlan, Request, ServeConfig

@functools.lru_cache(maxsize=None)
def _ref_path_model(model: TransformerLM) -> TransformerLM:
    """Plain-path twin (``ServeConfig.use_ref_path``): a shallow copy with
    ``use_kernels=False``, cached per model so every engine over the same
    model shares it (and its programs in :data:`_AOT_CACHE`)."""
    twin = copy.copy(model)
    twin.use_kernels = False
    return twin


@functools.lru_cache(maxsize=None)
def _kv_dtype_model(model: TransformerLM, kv_dtype: str) -> TransformerLM:
    """KV-storage twin (``ServeConfig.kv_dtype``): a shallow copy with
    ``kv_dtype`` rebound, cached per (model, dtype); parameters are
    shared, not copied."""
    twin = copy.copy(model)
    twin.kv_dtype = kv_dtype
    return twin


@functools.lru_cache(maxsize=None)
def _mesh_kernel_model(model: TransformerLM, mesh) -> TransformerLM:
    """Mesh twin: a shallow copy with ``kernel_mesh=mesh``, so the serve
    paths keep the pools split over the mesh and dispatch every kernel
    through ``ops.*_sharded`` onto this rank's slice.  Cached per (model,
    mesh) as JAX's is.  On a rank the mesh leaves out, setting the mesh
    raises the model's ``ValueError``."""
    twin = copy.copy(model)
    twin.kernel_mesh = mesh
    return twin


_graphs_off = False


@contextlib.contextmanager
def disable_graphs():
    """The port's ``jax.disable_jit()``: inside it an executor built on the
    card captures no CUDA graph, and every step runs eagerly, one launch
    at a time from the host.  Bucket selection, padding and every counter
    are unchanged, so a run inside it is the eager twin of the same run
    outside it."""
    global _graphs_off
    saved, _graphs_off = _graphs_off, True
    try:
        yield
    finally:
        _graphs_off = saved


def horizon_ladder(max_horizon: int) -> tuple[int, ...]:
    """The fused horizons the scheduler can plan (``plan_horizon`` rounds
    down to a power of two): 2, 4, ... up to ``max_horizon``."""
    return tuple(1 << i for i in range(1, max_horizon.bit_length()))


def select_bucket(n: int, buckets: tuple[int, ...] | None) -> int | None:
    """Smallest AOT bucket that can hold an ``n``-token (burst-aligned)
    prompt batch, or ``None`` on a miss — the caller then runs the eager
    prefill.  ``buckets`` is the sorted tuple ``ServeConfig.aot_buckets``
    normalized to."""
    if not buckets:
        return None
    for b in buckets:
        if b >= n:
            return b
    return None


class StepProgram:
    """One serve step's static input buffers: what a compiled program of
    the step reads (tokens, lengths or starts, page-table rows, lane
    masks).  A step loads its inputs into them (:meth:`load`) and runs the
    step over them; the persistent state (pools, page table, weights)
    belongs to the executor.  A CUDA graph of the step is bound to the
    executor whose pools it captured (:class:`_Graph`), so two executors
    may share a program but each captures its own graph of it."""

    def __init__(self, shapes: dict[str, tuple], device):
        self.inputs = {name: torch.zeros(shape, dtype=dt, device=device)
                       for name, (shape, dt) in shapes.items()}
        #: pinned host copies of the host-made inputs (the card only)
        self._staging = {}
        if torch.device(device).type == "cuda":
            self._staging = {name: torch.zeros(shape, dtype=dt,
                                               pin_memory=True)
                             for name, (shape, dt) in shapes.items()}

    def load(self, **values) -> dict[str, torch.Tensor]:
        """Copy one step's inputs into the static buffers and return them:
        numpy arrays through pinned host memory (each step ends in a host
        sync, so a staging buffer is never rewritten while its copy is in
        flight), device tensors on the device."""
        for name, v in values.items():
            buf = self.inputs[name]
            if isinstance(v, torch.Tensor):
                buf.copy_(v)
            elif self._staging:
                stage = self._staging[name]
                stage.numpy()[...] = v
                buf.copy_(stage, non_blocking=True)
            else:
                buf.copy_(torch.from_numpy(np.asarray(v)))
        return self.inputs

    def mask(self) -> dict[str, torch.Tensor]:
        """Inputs under which the step writes nothing live: every lane
        masked (``steps_left`` and ``active`` 0, ``lens`` 0) and every
        page-table row ``INVALID_PAGE``, so KV writes land in the scratch
        frame or are skipped.  The warm-up before a capture runs on them."""
        for name, buf in self.inputs.items():
            buf.fill_(INVALID_PAGE if name == "pt_rows" else 0)
        return self.inputs


#: bucket programs keyed as JAX's ``_aot_key``: (step-model twin, kind,
#: bucket, batch/pool geometry).  Module level, so every engine over the
#: same twin and geometry binds the same program; the int8 and plain-path
#: twins get their own.
_AOT_CACHE: dict[tuple, StepProgram] = {}


@functools.lru_cache(maxsize=None)
def _warmup_stream(device: torch.device):
    """The one side stream every capture's warm-up runs on: cuBLAS keeps a
    workspace for each stream it has run on, so a new stream per capture
    would keep one workspace per capture."""
    return torch.cuda.Stream(device)


@contextlib.contextmanager
def _no_gc():
    """Python's cyclic garbage collector off for the duration of a
    capture.  A collection that frees an engine dropped in a reference
    cycle (its pinned staging buffers, its graphs) makes CUDA calls —
    the host allocator records and queries an event for each pinned
    buffer a copy used — that are illegal while a stream captures and
    invalidate the capture; the garbage waits until the capture ends."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _launch_totals():
    """``(launches, routes)`` of every kernel wrapper, for a difference."""
    return ops.launch_counts(), ops.route_counts()


def _minus(a, b):
    """``a - b`` of two :func:`_launch_totals`, nonzero entries only."""
    launches = {k: a[0][k] - b[0][k] for k in a[0] if a[0][k] != b[0][k]}
    routes = {k: {r: n - b[1][k][r] for r, n in per.items()
                  if n != b[1][k][r]} for k, per in a[1].items()}
    return launches, {k: v for k, v in routes.items() if v}


class _Graph:
    """A program captured as a CUDA graph over one executor's state: the
    graph, its output (in the executor's graph pool) and the kernel
    launches and routes its capture recorded, which every replay adds to
    the wrappers' counters (a replay does not call them)."""

    def __init__(self, graph, out, launches, routes):
        self.graph, self.out = graph, out
        self.launches, self.routes = launches, routes
        self.replays = 0

    def replay(self):
        self.graph.replay()
        ops.add_launch_counts(self.launches, self.routes)
        self.replays += 1
        return self.out


class Executor:
    """Owns KV pools + the device page table; executes scheduler plans.

    With ``mesh`` (a ('kv', 'hd') serve mesh,
    :func:`repro_torch.launch.mesh.make_host_serve_mesh`) the KV pools are
    split over it while the page table and every scalar-plane operand stay
    whole on every rank; the Scheduler needs no change, which is the point
    of the split.  On a mesh of more than one rank no CUDA graph is
    captured (gloo collectives cannot be) and ``replays`` stays empty."""

    def __init__(self, model: TransformerLM, params: Any, cfg: ServeConfig,
                 vmem: VirtualMemory, cost: CostModel | None = None,
                 counters: PerfCounters | None = None, mesh=None):
        if cfg.aot_buckets and model.token_shape:
            raise ValueError(
                f"{model.cfg.name}: aot_buckets take 1-D token prompts, and "
                f"this model's tokens carry {model.token_shape[0]} codebooks "
                "each; the JAX engine fails to build its bucket programs for "
                "such a model, so the port refuses the combination (serve "
                "audio without aot_buckets)")
        if cfg.kv_dtype != model.kv_dtype:
            # quantized-pool twin FIRST: the pools below allocate its dtype
            model = _kv_dtype_model(model, cfg.kv_dtype)
        self.model = model
        self.params = params
        self.cfg = cfg
        self.vmem = vmem
        self.device = model.device
        self.counters = counters or PerfCounters()
        self.switcher = ContextSwitcher(vmem, cost)
        self.mesh = mesh
        self._step_model = model
        #: True iff compute steps run the plain versions on purpose
        self._ref_path = bool(cfg.use_ref_path)
        if self._ref_path:
            self._step_model = _ref_path_model(model)
        if mesh is not None:
            # the twins compose in JAX's order: kv dtype, plain path, mesh
            self._step_model = _mesh_kernel_model(self._step_model, mesh)
        # the device pool has num_pages frames; the allocator saw one less
        # (last frame = scratch for masked lanes); on a mesh the step
        # model's pools are split over it
        self.kv = self._step_model.init_kv_state(
            cfg.max_batch, cfg.num_pages, cfg.page_size, cfg.max_pages_per_seq
        )
        #: on a mesh of more than one rank, what the state is held to
        #: (:meth:`check_sharding_invariants`): the pools' declared
        #: placements and local shape, the local storage of each (every
        #: later update is in place: the port's counterpart of JAX's
        #: donation), and the replicated placements; else None
        self._layout = None
        if self._sharded:
            sh = executor_state_shardings(mesh, model.cfg.num_kv_heads,
                                          model.cfg.head_dim)
            whole = torch.empty(self.kv.k_pools.shape, device="meta")
            self._layout = dict(
                pool=sh["pool"], replicated=sh["replicated"],
                local=tuple(ops.local_slice(whole, mesh, sh["pool"]).shape),
                ptrs={n: getattr(self.kv, n).to_local().data_ptr()
                      for n in ("k_pools", "v_pools")})
        #: persistent satp: updated by delta scatter, read by every step
        self._ptab = torch.full(
            (cfg.max_batch, cfg.max_pages_per_seq), INVALID_PAGE,
            dtype=torch.int32, device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        #: every step program, keyed (kind, n): ("decode", 1),
        #: ("decode_multi", K) for K on the horizon ladder, and the bucket
        #: programs ("prefill" / "continue", bucket)
        vec = ((cfg.max_batch,), torch.int32)
        #: one token per lane: ``[max_batch]``, ``[max_batch, C]`` audio
        toks = ((cfg.max_batch,) + model.token_shape, torch.int32)
        self._programs: dict[tuple[str, int], StepProgram] = {
            ("decode", 1): StepProgram(dict(
                tokens=toks, pre_lens=vec,
                active=((cfg.max_batch,), torch.bool)), self.device)}
        for k in horizon_ladder(cfg.max_horizon):
            self._programs[("decode_multi", k)] = StepProgram(
                dict(tokens=toks, pre_lens=vec, steps_left=vec), self.device)
        #: the bucket programs of THIS engine, (kind, bucket) -> program,
        #: bound at build (``ServeConfig.aot_buckets``)
        self._aot: dict[tuple[str, int], StepProgram] = {}
        if cfg.aot_buckets:
            self._compile_aot()
        #: the CUDA graph of each program, captured at build on the card;
        #: none on a mesh of more than one rank (its collectives sync with
        #: the host), where every program runs eagerly over its buffers
        self._graphs: dict[tuple[str, int], _Graph] = {}
        if (self.device.type == "cuda" and not _graphs_off
                and not self._sharded):
            self._pool = torch.cuda.graph_pool_handle()
            for key in self._programs:
                self._graphs[key] = self._capture(key)

    @property
    def _sharded(self) -> bool:
        """Whether the state is split over a mesh of more than one rank."""
        return self.mesh is not None and self.mesh.size() > 1

    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _block(self) -> None:
        """Wait for the device so the step timers measure execution."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # AOT-bucketed prefill (ServeConfig.aot_buckets)
    # ------------------------------------------------------------------

    def _aot_key(self, kind: str, bucket: int) -> tuple:
        """Module-cache key: everything a bucket program's buffers and
        step derive from.  The kv-dtype and plain-path twins are folded
        into ``self._step_model``, so distinct twins get distinct programs
        and identical twins share."""
        return (self._step_model, kind, bucket, self.cfg.max_batch,
                self.cfg.num_pages, self.cfg.page_size,
                self.cfg.max_pages_per_seq)

    def _aot_operands(self, kind: str, bucket: int) -> dict[str, tuple]:
        """``(shape, dtype)`` of each input of one bucketed step: full
        ``max_batch`` rows, ``bucket``-length prompts, the page-table
        rows."""
        b = self.cfg.max_batch
        ops_ = dict(tokens=((b, bucket), torch.int32),
                    lens=((b,), torch.int32),
                    pt_rows=((b, self.cfg.max_pages_per_seq), torch.int32))
        if kind == "continue":
            ops_["starts"] = ((b,), torch.int32)
        return ops_

    def _compile_aot(self) -> None:
        """Bind a prefill and a continuation program per bucket at engine
        build, from :data:`_AOT_CACHE` where an engine over the same twin
        and geometry made it already."""
        for kind in ("prefill", "continue"):
            for bucket in self.cfg.aot_buckets:
                key = self._aot_key(kind, bucket)
                prog = _AOT_CACHE.get(key)
                if prog is None:
                    prog = _AOT_CACHE[key] = StepProgram(
                        self._aot_operands(kind, bucket), self.device)
                self._aot[(kind, bucket)] = prog
        self._programs.update(self._aot)

    def _select_aot(self, kind: str, reqs: list[Request]) -> int | None:
        """The bucket of this batch, or ``None`` to run the eager step.
        Hits and misses are counted only when bucketing is configured; a
        miss is a batch whose burst-aligned width exceeds every bucket (or
        whose prompts are not 1-D, which the buckets were not built for)."""
        if not self._aot:
            return None
        page = self.cfg.page_size
        smax = -(-max(len(r.prompt) for r in reqs) // page) * page
        bucket = None
        if not reqs[0].prompt.shape[1:]:     # 1-D token prompts only
            bucket = select_bucket(smax, self.cfg.aot_buckets)
        if bucket is None:
            self.counters.inc("aot_misses")
            return None
        self.counters.inc("aot_hits")
        return bucket

    # ------------------------------------------------------------------
    # step programs: bodies, capture, replay
    # ------------------------------------------------------------------

    def _body(self, key: tuple[str, int]):
        """The step function of program ``key`` over its inputs; reads and
        writes the persistent pools and page table in place and returns
        the logits (``[B, V]``; ``[B, C, V]`` audio) or the token block
        (``[K, B]``; ``[K, B, C]`` audio)."""
        kind, n = key
        if kind == "decode_multi":
            return functools.partial(self._decode_multi_body, horizon=n)
        return {"decode": self._decode_body, "prefill": self._prefill_body,
                "continue": self._continue_body}[kind]

    def _prefill_body(self, tokens, lens, pt_rows):
        logits, _ = self._step_model.prefill(
            self.params, tokens, lens,
            self._state(pt_rows, torch.zeros_like(lens)))
        return logits

    def _continue_body(self, tokens, starts, lens, pt_rows):
        logits, _ = self._step_model.prefill_continue(
            self.params, tokens, starts, lens, self._state(pt_rows, starts))
        return logits

    def _decode_body(self, tokens, pre_lens, active):
        # mask rows of slots NOT decoding this step: their KV write must
        # land in the scratch row, never in a live frame
        masked = torch.where(active[:, None], self._ptab, INVALID_PAGE)
        logits, _ = self._step_model.decode_step(
            self.params, tokens, self._state(masked, pre_lens))
        return logits

    def _decode_multi_body(self, tokens, pre_lens, steps_left, *, horizon):
        block, _ = self._step_model.decode_multi_step(
            self.params, tokens, self._state(self._ptab, pre_lens),
            steps_left, self._gen, float(self.cfg.temperature),
            horizon=horizon, greedy=self.cfg.greedy)
        return block

    def _capture(self, key: tuple[str, int]) -> _Graph:
        """Warm program ``key`` up on a side stream over masked inputs,
        then capture it as a CUDA graph in the executor's pool.  Neither
        counts as a launch of the run: the wrappers' counters are put back,
        and the capture's own launches are what each replay adds.  The
        capture must launch what the warm-up launched, route for route.
        Errors propagate: there is no eager fallback."""
        body, inputs = self._body(key), self._programs[key].mask()
        before, rng = _launch_totals(), self._gen.get_state()
        main = torch.cuda.current_stream(self.device)
        side = _warmup_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            body(**inputs)
        main.wait_stream(side)
        warm = _launch_totals()
        graph = torch.cuda.CUDAGraph()
        if key[0] == "decode_multi" and not self.cfg.greedy:
            # the horizon samples on the device from the executor's
            # generator; each replay advances it as the eager draws would
            graph.register_generator_state(self._gen)
        with _no_gc(), torch.cuda.graph(graph, pool=self._pool):
            out = body(**inputs)
        after = _launch_totals()
        self._gen.set_state(rng)
        launches, routes = _minus(after, warm)
        if (launches, routes) != _minus(warm, before):
            raise RuntimeError(
                f"capture of {key} launched {launches} {routes}, its warm-up "
                f"{_minus(warm, before)}")
        back = _minus(before, after)
        ops.add_launch_counts(*back)
        return _Graph(graph, out, launches, routes)

    def _step(self, key: tuple[str, int], **inputs) -> torch.Tensor:
        """Run one step: replay program ``key``'s graph after loading its
        inputs; on the CPU, or in an executor built inside
        :func:`disable_graphs`, run the step over the program's buffers.
        Inside :func:`disable_graphs`, and for a batch no bucket holds
        (``key`` has no program), run it eagerly on fresh tensors."""
        prog = self._programs.get(key)
        if prog is None or _graphs_off:
            return self._body(key)(**{
                n: v if isinstance(v, torch.Tensor)
                else torch.as_tensor(v, device=self.device)
                for n, v in inputs.items()})
        prog.load(**inputs)
        graph = self._graphs.get(key)
        if graph is None:
            return self._body(key)(**prog.inputs)
        return graph.replay()

    @property
    def replays(self) -> dict[tuple[str, int], int]:
        """Replays of each captured program so far."""
        return {k: g.replays for k, g in self._graphs.items()}

    # ------------------------------------------------------------------
    # sharding invariants (mesh mode)
    # ------------------------------------------------------------------

    def check_sharding_invariants(self, extra=()) -> None:
        """On a mesh of more than one rank: the persistent state must still
        have its declared layout after each mutation (the page-table sync,
        a compute step, a spill, a restore).  The pools are DTensors on
        the mesh with the placements and the local shape declared at build
        and still the local storage allocated then (every update is in
        place); the page table is a plain ``[max_batch, max_pages_per_seq]``
        int32 tensor; each ``(name, tensor)`` of ``extra`` (a step's logits
        or token block) is whole on every rank, not a DTensor split or
        pending a reduction.  Metadata only: no device sync.  A drift
        raises ``RuntimeError`` (not ``assert``, which ``python -O``
        drops)."""
        if self._layout is None:
            return
        lay, cfg = self._layout, self.cfg
        pool_l, local = tuple(lay["pool"]), lay["local"]
        for name in ("k_pools", "v_pools"):
            t = getattr(self.kv, name)
            if not (ops.is_dtensor(t) and t.device_mesh == self.mesh
                    and tuple(t.placements) == pool_l
                    and tuple(t.to_local().shape) == local
                    and t.to_local().data_ptr() == lay["ptrs"][name]):
                raise RuntimeError(
                    f"executor {name} drifted off its declared layout: "
                    f"{type(t).__name__} {getattr(t, 'placements', None)} "
                    f"local {tuple(ops.local_of(t).shape)}, declared "
                    f"{pool_l} local {local} in its storage "
                    "of the build")
        pt = self._ptab
        if (ops.is_dtensor(pt) or pt.dtype != torch.int32 or tuple(pt.shape)
                != (cfg.max_batch, cfg.max_pages_per_seq)):
            raise RuntimeError(
                f"executor page_table drifted off its declared layout: "
                f"{type(pt).__name__} {pt.dtype} {tuple(pt.shape)}")
        for name, t in extra:
            if ops.is_dtensor(t) and (tuple(t.placements)
                                      != tuple(lay["replicated"])):
                raise RuntimeError(
                    f"executor {name} is not whole on every rank: "
                    f"{tuple(t.placements)}")

    # ------------------------------------------------------------------
    # persistent device page table
    # ------------------------------------------------------------------

    def sync_page_table(self) -> None:
        """Apply host page-table deltas (dirty rows only) to the device."""
        rows, vals = self.vmem.drain_dirty_rows()
        if rows.size:
            self._ptab[self._tensor(rows, torch.long)] = self._tensor(vals)
            self.counters.inc("ptab_rows_uploaded", int(rows.size))
            self.counters.inc("ptab_syncs")
            self.check_sharding_invariants()

    # ------------------------------------------------------------------
    # compute steps
    # ------------------------------------------------------------------

    def _count_dispatch(self) -> None:
        """Kernel-vs-plain observability, once per compute step."""
        if self._ref_path:
            self.counters.inc("ref_path_dispatches")
        else:
            self.counters.inc("kernel_dispatches")
        if self._step_model.kv_dtype != "native":
            self.counters.inc("quant_dispatches")

    def _state(self, page_table, seq_lens) -> PagedKVState:
        return PagedKVState(self.kv.k_pools, self.kv.v_pools, page_table,
                            seq_lens)

    def _pad_prompt_batch(self, reqs: list[Request],
                          bucket: int | None = None):
        """Burst-aligned ``[B, smax]`` prompt matrix (``[B, smax, C]``
        audio) + true lengths (numpy)
        + the batch's page-table rows (on the device) — shared by cold and
        forked admission, so padding and slot lookup cannot drift between
        them.

        With ``bucket`` (a bucket program) the batch is padded to the
        program's shape, ``max_batch`` rows of ``bucket`` tokens: pad rows
        carry ``lens`` 0 and ``INVALID_PAGE`` table rows (no write lands),
        pad columns sit past every real row's length, so causal attention
        keeps them out of every real row.  The padded cells beyond what the
        unbucketed step would carry are counted as ``bucket_pad_tokens``."""
        page = self.cfg.page_size
        smax = max(len(r.prompt) for r in reqs)
        smax = -(-smax // page) * page            # burst-align
        nrows = rows = len(reqs)
        if bucket is not None:
            self.counters.inc("bucket_pad_tokens",
                              self.cfg.max_batch * bucket - nrows * smax)
            smax, rows = bucket, self.cfg.max_batch
        tokens = np.zeros((rows, smax) + reqs[0].prompt.shape[1:], np.int32)
        for i, r in enumerate(reqs):
            tokens[i, : len(r.prompt)] = r.prompt
        lens = np.zeros((rows,), np.int32)
        lens[:nrows] = [len(r.prompt) for r in reqs]
        slots = [self.vmem.seq(r.req_id).slot for r in reqs]
        pt_rows = self._ptab.index_select(0, self._tensor(slots, torch.long))
        if rows > nrows:
            pt_rows = torch.cat([pt_rows, pt_rows.new_full(
                (rows - nrows, pt_rows.shape[1]), INVALID_PAGE)])
        return tokens, lens, pt_rows

    def prefill(self, reqs: list[Request]) -> list[np.ndarray]:
        """Batched prefill of freshly admitted requests; returns the first
        sampled token per request (request order)."""
        self.sync_page_table()
        bucket = self._select_aot("prefill", reqs)
        tokens, lens, pt_rows = self._pad_prompt_batch(reqs, bucket=bucket)
        with self.counters.timer("prefill"):
            logits = self._step(("prefill", bucket), tokens=tokens,
                                lens=lens, pt_rows=pt_rows)
            self._block()
        self._count_dispatch()
        self.check_sharding_invariants(extra=(("prefill_logits", logits),))
        first = self.sample(logits)
        return [np.asarray(first[i]) for i in range(len(reqs))]

    def decode(self, tokens: np.ndarray, pre_lens: np.ndarray,
               active: np.ndarray) -> np.ndarray:
        """One full-slot decode step (the horizon's K=1 collapse path);
        returns sampled tokens by slot."""
        self.sync_page_table()
        with self.counters.timer("decode"):
            logits = self._step(("decode", 1), tokens=tokens,
                                pre_lens=pre_lens, active=active)
            self._block()
        self._count_dispatch()
        self.check_sharding_invariants(extra=(("decode_logits", logits),))
        self.counters.inc("decode_dispatches")
        self.counters.inc("decode_horizon")
        return self.sample(logits)

    def decode_multi(self, plan: DecodePlan) -> np.ndarray:
        """Fused K-step decode horizon: ``plan.horizon`` chained decode
        steps with on-device sampling and per-lane retire masking, then the
        whole ``[K, B]`` (``[K, B, C]`` audio) token block in one host
        transfer."""
        key = ("decode_multi", plan.horizon)
        if key not in self._programs:
            raise ValueError(f"horizon {plan.horizon} is not on the ladder "
                             f"{horizon_ladder(self.cfg.max_horizon)}")
        self.sync_page_table()
        with self.counters.timer("decode"):
            block = self._step(key, tokens=plan.tokens,
                               pre_lens=plan.pre_lens,
                               steps_left=plan.steps_left)
            out = block.to(torch.int32).cpu().numpy()   # the one host sync
        self._count_dispatch()
        self.check_sharding_invariants(extra=(("decode_block", block),))
        self.counters.inc("host_syncs")
        self.counters.inc("decode_dispatches")
        self.counters.inc("decode_horizon", plan.horizon)
        return out

    # ------------------------------------------------------------------
    # DataPlane protocol (driven by the Scheduler)
    # ------------------------------------------------------------------

    def _continuation_gather_bytes(self, start_lens, smax: int,
                                   nrows: int) -> int:
        """K+V bytes the continuation attention reads per layer stack, by
        the route that ran: a kernel fetches ``pages_touched`` pages per
        row with its route's query block (the serve path's views are
        aligned, so the route follows from dtypes and shapes), the plain
        version gathers every row's full table reach.  The model's whole
        ``Hkv x hd`` is counted on a mesh too, never a rank's slice, as
        JAX counts it."""
        cfg = self.model.cfg
        per_tok = (2 * cfg.num_kv_heads * cfg.head_dim
                   * self.kv.k_pools.dtype.itemsize)
        if ops.kernel_route(self.kv.k_pools, self._step_model.use_kernels):
            route = prefill_route_rule(
                self._step_model.dtype, self.kv.k_pools.dtype,
                cfg.q_per_kv, cfg.head_dim, self.cfg.page_size)
            bq = query_block(cfg.q_per_kv, route)
            pages = sum(pages_touched(st, smax, self.cfg.max_pages_per_seq,
                                      page_size=self.cfg.page_size, bq=bq)
                        for st in start_lens)
            tokens = pages * self.cfg.page_size
        else:
            tokens = nrows * self.cfg.max_pages_per_seq * self.cfg.page_size
        return cfg.num_layers * per_tok * tokens

    def _copy_pages(self, copies: list[tuple[int, int]]) -> None:
        """Copy-on-write tail pages: every forked frame of both pools in one
        indexed assignment each, in place (on a mesh, of this rank's
        slices)."""
        srcs = self._tensor([src for src, _ in copies], torch.long)
        dsts = self._tensor([dst for _, dst in copies], torch.long)
        for pools in (self.kv.k_pools, self.kv.v_pools):
            local = ops.local_of(pools)
            local[:, dsts] = local[:, srcs]

    def admit_forked_batch(self, reqs: list[Request], start_lens: list[int],
                           tail_copies: list[tuple[int, int] | None]
                           ) -> list[np.ndarray]:
        """COW tail copies + ONE batched continuation prefill for all
        same-step forked admissions (each request's chunk starts at its own
        logical offset); returns the first sampled token per request."""
        self.sync_page_table()
        copies = [tc for tc in tail_copies if tc is not None]
        if copies:
            self._copy_pages(copies)
        bucket = self._select_aot("continue", reqs)
        chunks, lens, pt_rows = self._pad_prompt_batch(reqs, bucket=bucket)
        starts = np.zeros((chunks.shape[0],), np.int32)
        starts[: len(reqs)] = start_lens
        with self.counters.timer("prefill"):
            logits = self._step(("continue", bucket), tokens=chunks,
                                starts=starts, lens=lens, pt_rows=pt_rows)
            self._block()
        self._count_dispatch()
        self.check_sharding_invariants(extra=(("continue_logits", logits),))
        self.counters.inc("continuation_prefill_tokens", int(lens.sum()))
        self.counters.inc("prefill_bytes_gathered",
                          self._continuation_gather_bytes(
                              [int(s) for s in start_lens],
                              int(chunks.shape[1]), len(reqs)))
        first = self.sample(logits)
        return [np.asarray(first[i]) for i in range(len(reqs))]

    def preload_prefix(self, prefix_tokens, slot: int, n: int) -> None:
        """Prefill the resident shared prefix into the frames mapped for
        ``slot`` (one cold prefill of the burst-aligned prefix)."""
        self.sync_page_table()
        page = self.cfg.page_size
        tokens = np.zeros((1, -(-n // page) * page), np.int32)
        tokens[0, :n] = np.asarray(prefix_tokens, np.int32)
        pt_rows = self._ptab.index_select(0, self._tensor([slot], torch.long))
        self._prefill_body(self._tensor(tokens), self._tensor([n]), pt_rows)
        self._count_dispatch()
        self.counters.inc("prefix_tokens", n)

    def spill(self, req: Request) -> None:
        """Page-granular spill: only the victim's frames leave the device."""
        self.switcher.spill_kv(req.req_id, self.kv.k_pools, self.kv.v_pools)
        self.check_sharding_invariants()

    def restore(self, req: Request, num_tokens: int,
                shared_pages: list[int] | None = None) -> None:
        """Page-granular restore into freshly allocated frames.

        ``shared_pages``: leading frames the scheduler proved are still
        the pinned prefix's — re-shared by refcount, not written.
        ``num_tokens`` may be shorter than the spilled length (partial
        restore): only the leading part is written back, and the
        scheduler re-prefills the rest through the continuation path."""
        spilled = self.switcher.spilled_len(req.req_id)
        if num_tokens > spilled:
            raise ValueError(
                f"restore of req {req.req_id}: scheduler asks {num_tokens} "
                f"tokens, the switcher spilled only {spilled}")
        self.switcher.restore_kv(
            req.req_id, self.kv.k_pools, self.kv.v_pools,
            shared_prefix_pages=shared_pages, num_tokens=num_tokens)
        self.check_sharding_invariants()

    def discard(self, req: Request) -> None:
        """Free a failed request's host-side swap record (never restored)."""
        self.switcher.discard(req.req_id)

    def export_swap(self, req: Request):
        """Detach the victim's portable swap record (host bytes in the
        pool's storage dtype — int8 stays narrow) so the router can
        migrate it to another replica's executor."""
        return self.switcher.export_swap(req.req_id)

    def import_swap(self, req: Request, record) -> None:
        """Adopt a swap record exported from another replica's executor;
        the switcher validates the page geometry before anything moves.
        The bytes reach this executor's pools at the restore, in place
        (``index_copy_``), so the pool tensors that captured graphs
        point at are never reallocated."""
        self.switcher.import_swap(record)

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------

    def sample(self, logits: torch.Tensor) -> np.ndarray:
        """Host-path sampling (prefill boundaries and the K=1 decode
        collapse path); every call forces one device->host sync.  It draws
        from the executor's generator exactly as the fused path does."""
        self.counters.inc("host_syncs")
        tok = sample(logits, self._gen, float(self.cfg.temperature),
                     self.cfg.greedy)
        return tok.to(torch.int32).cpu().numpy()

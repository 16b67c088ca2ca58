"""Host-side serving policy — the CVA6/OS plane of the serving split.

AraOS keeps the scalar core (CVA6) in charge of translation and OS policy
while the Ara2 vector datapath streams bursts; the vector unit only hits
peak when the scalar side stays off its critical path.  The serving engine
mirrors that split: this module is the *scalar/OS plane* — admission
control, victim selection, fork bookkeeping, page-table policy — and it
owns **no device arrays**.  All state here is Python/NumPy, so the
scheduler is unit-testable without a device (see
``tests/test_serve_scheduler.py``, which drives it with a fake data plane).

Data movement (KV page copies, prefill/decode dispatch) is delegated to a
:class:`DataPlane` — in production the device-resident
:class:`repro_torch.serve.executor.Executor`; in tests the :class:`HostOnlyPlane`
stub below.  The scheduler decides *what* moves; the plane decides *how*.

All per-replica mutable scheduling state (queues, running set, swap
records, the step clock, the resident-prefix length) is factored into
:class:`ReplicaState`, so a multi-replica control plane
(:class:`repro_torch.serve.router.ReplicaRouter`) is N schedulers over N data
planes with zero shared mutable state — the single-replica engine is
exactly the N=1 instance of that layering.

**Radix prefix layer.**  Admission consults a per-replica
:class:`~repro_torch.serve.prefix_cache.PrefixCache` — a page-granularity radix
trie over the token content of resident mapped runs — before allocating:
a prompt whose leading whole pages match a registered run is admitted by
COW-forking those pages from the owner (``fork_seq`` refcounts, no fork
API on the request) and prefilling only the divergent chunk through the
same batched continuation path forked admissions use.  Sequences are
registered only after their prompt KV commits (``finish_prefill`` /
``_flush_forked`` / ``register_resident``) and evicted automatically via
the ``VirtualMemory`` unmap hook, so the trie always describes live
frames.  Counters: ``prefix_hits``, ``pages_reused``,
``prefill_tokens_skipped``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Protocol

import numpy as np

from repro_torch.core import CostModel, OutOfPagesError, PerfCounters, VirtualMemory
from repro_torch.serve.prefix_cache import PrefixCache


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray              # [len] int32 (or [len, K] audio)
    max_new_tokens: int
    output: list[Any] = dataclasses.field(default_factory=list)
    status: str = "queued"          # queued|running|swapped|done|failed
    arrival: int = 0                # engine step of submission
    share_prefix: bool = False      # fork from the engine's resident prefix

    prefix_len: int = 0             # set by the scheduler on forked admission

    #: per-token stream sink (set from ``ServeRequest.stream_callback``);
    #: invoked by the async detokenize thread, never by the scheduler
    stream_callback: Callable | None = None
    #: SLO timestamps (``time.perf_counter``), captured by the scheduler
    #: at host-visible commit points — submit / first committed token /
    #: every committed token — NEVER at detokenize, so async streaming
    #: cannot skew TTFT/TPOT (see repro_torch.serve.api.RequestTiming)
    t_enqueue: float = 0.0
    t_first_token: float = 0.0
    t_last_token: float = 0.0
    #: peak mapped-page footprint over the request's lifetime
    pages_peak: int = 0

    @property
    def total_len(self) -> int:
        return self.prefix_len + len(self.prompt) + len(self.output)

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.output)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    page_size: int = 16
    num_pages: int = 256            # physical frames (1 reserved as scratch)
    max_pages_per_seq: int = 32
    max_batch: int = 8
    greedy: bool = True
    temperature: float = 1.0
    seed: int = 0
    tick_every_steps: int = 50      # scheduler tick accounting cadence
    #: fused decode horizon cap: the executor may run up to this many
    #: chained decode steps per dispatch (1 disables fusion).  The auto
    #: horizon is rounded down to a power of two so the jit cache stays
    #: O(log max_horizon) entries.
    max_horizon: int = 8
    #: partial restore: after this many CONSECUTIVE capacity-blocked
    #: ``try_restore`` passes at the swap-FIFO head, the scheduler stops
    #: waiting for an all-or-nothing restore, restores the longest
    #: page-aligned prefix of the victim that fits the pool right now and
    #: re-enqueues the request to re-prefill only the evicted tail through
    #: the continuation path (``partial_restores``/``pages_refilled``).
    #: 0 disables partial restore (strict all-or-nothing restores).
    restore_patience: int = 6
    #: second-chance restore scan: how many victims PAST a
    #: ``RestoreFailure``-blocked FIFO head one ``try_restore`` pass may
    #: attempt (mirroring the bounded admission scan), so a head pinned to
    #: a failing plane cannot starve the rest of the swap queue.  The head
    #: is never popped out of order.  0 restores strict head-only retry.
    restore_scan_limit: int = 4
    #: explicit escape hatch (``--no-kernels`` in launch.serve): dispatch
    #: every compute step through a ``use_kernels=False`` twin of the
    #: model — the plain PyTorch versions of the kernels, even on the
    #: card; any dispatch through the twin is counted as
    #: ``ref_path_dispatches`` so the hatch is observable, not silent.
    use_ref_path: bool = False
    #: KV pool storage dtype: "native" keeps the model compute dtype;
    #: "int8" makes the executor bind a quantized-pool model twin — pools
    #: allocate int8, writes quantize, and the paged-attention kernel
    #: dequantizes each page after its load, so the kernel path stays live
    #: (``quant_dispatches`` counts it).  Spill/restore then moves the
    #: narrow bytes verbatim.  ``--kv-dtype`` in launch.serve.
    kv_dtype: str = "native"
    #: global radix prefix cache: admissions whose leading whole pages
    #: match a resident registered run are COW-mapped from the owner and
    #: prefill skips the matched tokens (continuation path).  Token
    #: streams are identical either way (causal KV is a pure function of
    #: the token prefix); disable for a cold-admission baseline
    #: (``--no-prefix-cache`` in launch.serve, the bench reference).
    prefix_cache: bool = True
    #: AOT-bucketed prefill: prompt batches are padded up to the smallest
    #: of these lengths and dispatched through executables pre-lowered and
    #: compiled at engine build (``aot_compile`` against
    #: ``ShapeDtypeStruct``s), so no request pays a first-hit jit stall.
    #: Buckets must be positive ``page_size`` multiples within the
    #: page-table reach; ``None`` (default) keeps the plain shape-keyed
    #: jit path.  Padding is numerically inert — pad rows carry lens=0 and
    #: INVALID_PAGE table rows (routed to the scratch/trash frame) and
    #: causal masking keeps pad columns out of every real row — so greedy
    #: streams are bit-identical to the unbucketed dispatch.  Counters:
    #: ``aot_hits`` / ``aot_misses`` / ``bucket_pad_tokens``.
    aot_buckets: tuple[int, ...] | None = None
    #: serve-mesh request: "off" (single device), "auto" (factor all
    #: visible devices over ('kv','hd')), or an integer device count.
    #: Resolved to a concrete mesh by :meth:`build_mesh` — the one place
    #: the flag is interpreted (``--serve-mesh`` in launch.serve).
    serve_mesh: str = "off"

    def __post_init__(self) -> None:
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (one frame is reserved as the "
                f"masked-lane scratch), got {self.num_pages}")
        if self.max_batch < 1 or self.max_horizon < 1:
            raise ValueError(
                f"max_batch ({self.max_batch}) and max_horizon "
                f"({self.max_horizon}) must be >= 1")
        if self.restore_patience < 0 or self.restore_scan_limit < 0:
            raise ValueError(
                f"restore_patience ({self.restore_patience}) and "
                f"restore_scan_limit ({self.restore_scan_limit}) must be "
                ">= 0 (0 disables the mechanism)")
        if self.kv_dtype not in ("native", "int8"):
            raise ValueError(
                f"kv_dtype must be 'native' or 'int8', got "
                f"{self.kv_dtype!r} (fp8 pools are a roadmap item, not a "
                "silent fallback)")
        if not self.greedy and self.temperature <= 0:
            raise ValueError(
                f"temperature must be > 0 for stochastic sampling, got "
                f"{self.temperature}")
        if self.serve_mesh not in ("off", "auto"):
            try:
                int(self.serve_mesh)
            except (TypeError, ValueError):
                raise ValueError(
                    f"serve_mesh must be 'off', 'auto' or a device count, "
                    f"got {self.serve_mesh!r}") from None
        if self.aot_buckets is not None:
            buckets = tuple(sorted({int(b) for b in self.aot_buckets}))
            if not buckets:
                object.__setattr__(self, "aot_buckets", None)
                return
            reach = self.max_pages_per_seq * self.page_size
            for b in buckets:
                if b <= 0 or b % self.page_size:
                    raise ValueError(
                        f"aot_buckets must be positive multiples of "
                        f"page_size={self.page_size}, got {b}")
                if b > reach:
                    raise ValueError(
                        f"aot bucket {b} exceeds the page-table reach "
                        f"({self.max_pages_per_seq} pages x "
                        f"{self.page_size} = {reach} tokens): no prompt "
                        "that long can ever be admitted")
            object.__setattr__(self, "aot_buckets", buckets)

    # ------------------------------------------------------------------
    # the ONE flag surface (launch.serve and every benchmark share it)
    # ------------------------------------------------------------------

    @staticmethod
    def add_args(ap) -> None:
        """Register the serving flags on an ``argparse`` parser — the
        single authoritative flag set (``from_args`` consumes it)."""
        ap.add_argument("--page-size", type=int, default=8)
        ap.add_argument("--num-pages", type=int, default=64,
                        help="small pools force preemption (context "
                             "switches)")
        ap.add_argument("--max-batch", type=int, default=4)
        ap.add_argument("--max-horizon", type=int, default=8,
                        help="fused decode horizon cap: up to K chained "
                             "decode steps per dispatch with on-device "
                             "sampling (1 disables fusion)")
        ap.add_argument("--serve-mesh", default="off",
                        help="shard the executor's KV pools over a "
                             "('kv','hd') serve mesh: 'auto' factors all "
                             "visible devices, an integer caps the device "
                             "count, 'off' (default) keeps single-device "
                             "placement; only 'off' is ported")
        ap.add_argument("--no-prefix-cache", action="store_true",
                        help="disable the radix prefix cache (cold-"
                             "admission baseline)")
        ap.add_argument("--no-kernels", action="store_true",
                        help="explicit escape hatch: dispatch every "
                             "compute step through the plain torch twin "
                             "(counted as ref_path_dispatches)")
        ap.add_argument("--kv-dtype", choices=("native", "int8"),
                        default="native",
                        help="KV pool storage dtype: int8 stores "
                             "quantized pages; the paged-attention "
                             "kernel dequantizes after the load "
                             "(quant_dispatches)")
        ap.add_argument("--aot-buckets", default="off",
                        help="comma-separated prompt-length buckets "
                             "(not ported: only 'off' is accepted by the "
                             "engine)")

    @classmethod
    def from_args(cls, args, **overrides) -> "ServeConfig":
        """Build a validated config from an ``add_args`` namespace.

        This replaces the per-call-site flag re-parsing that used to live
        in ``launch.serve`` (manual ServeConfig construction, a separate
        mesh block, ad-hoc stats headers): one parse, one validation, one
        ``describe()``.  ``overrides`` wins over flags (callers computing
        ``max_pages_per_seq`` from the workload pass it here).
        """
        buckets: tuple[int, ...] | None = None
        raw = getattr(args, "aot_buckets", "off")
        if raw not in (None, "", "off"):
            try:
                buckets = tuple(int(b) for b in str(raw).split(","))
            except ValueError:
                raise ValueError(
                    f"--aot-buckets must be a comma-separated int list or "
                    f"'off', got {raw!r}") from None
        fields = dict(
            page_size=args.page_size,
            num_pages=args.num_pages,
            max_batch=args.max_batch,
            max_horizon=args.max_horizon,
            use_ref_path=args.no_kernels,
            prefix_cache=not args.no_prefix_cache,
            kv_dtype=args.kv_dtype,
            serve_mesh=args.serve_mesh,
            aot_buckets=buckets,
        )
        if hasattr(args, "seed"):
            fields["seed"] = args.seed
        fields.update(overrides)
        return cls(**fields)

    def describe(self) -> str:
        """The shared stats header: one canonical rendering of the
        config, printed by ``launch.serve`` and the benchmarks."""
        compute = "plain torch (explicit hatch)" if self.use_ref_path \
            else "cuda kernels"
        buckets = ",".join(str(b) for b in self.aot_buckets) \
            if self.aot_buckets else "off"
        return (
            f"serve config: page_size={self.page_size} "
            f"num_pages={self.num_pages} (1 scratch) "
            f"max_pages_per_seq={self.max_pages_per_seq} "
            f"max_batch={self.max_batch} max_horizon={self.max_horizon}\n"
            f"  compute: {compute}, kv_dtype={self.kv_dtype}, "
            f"prefix_cache={'on' if self.prefix_cache else 'off'}, "
            f"sampling={'greedy' if self.greedy else f'T={self.temperature}'}"
            f"\n  aot prefill buckets: {buckets}\n"
            f"  serve mesh: {self.serve_mesh}"
        )

    def build_mesh(self, model_cfg):
        """Resolve ``serve_mesh``: only ``"off"`` (one card) is ported; a
        sharded serve mesh waits for the sharded-executor slice."""
        if self.serve_mesh in (None, "off"):
            return None
        raise NotImplementedError(
            f"serve_mesh={self.serve_mesh!r}: the sharded executor is not "
            "ported yet (a later slice of the PyTorch port); use 'off'")


class RestoreFailure(RuntimeError):
    """A data plane's restore transiently failed (device OOM, transfer
    error, an injected fault).  The contract: the plane must raise BEFORE
    any side effect (no pages re-mapped, no bytes moved), so the scheduler
    can leave the victim at the head of the swap FIFO and retry on a later
    step.  Counted as ``restore_failures``."""


@dataclasses.dataclass
class ReplicaState:
    """All per-replica mutable scheduling state, in one introspectable
    object.

    Factored out of :class:`Scheduler` so a multi-replica router can hold
    N of these (one per data plane) and reason about them uniformly —
    request conservation, page accounting, clock skew — while the
    scheduler's policy methods stay exactly the single-replica code.  The
    scheduler exposes the historical attribute names (``queue``,
    ``running``, ``step_i``, ...) as properties over this object, so the
    N=1 path is byte-for-byte the pre-router behavior.
    """

    replica_id: int = 0
    queue: deque[Request] = dataclasses.field(default_factory=deque)
    swapped: deque[int] = dataclasses.field(default_factory=deque)
    running: dict[int, Request] = dataclasses.field(default_factory=dict)
    done: dict[int, Request] = dataclasses.field(default_factory=dict)
    slot_of: dict[int, int] = dataclasses.field(default_factory=dict)
    swap_requests: dict[int, Request] = dataclasses.field(
        default_factory=dict)
    spilled_tokens: dict[int, int] = dataclasses.field(default_factory=dict)
    #: spill-time provenance: the victim's leading frames that WERE the
    #: pinned prefix's frames (refcount-shared).  A restore re-shares them
    #: instead of demanding fresh frames — the reason a victim whose full
    #: footprint exceeds the preemptible pool can still be reachable.
    spilled_shared: dict[int, list[int]] = dataclasses.field(
        default_factory=dict)
    #: consecutive capacity-blocked ``try_restore`` passes per FIFO-head
    #: victim — the patience clock that arms a partial restore
    restore_blocked: dict[int, int] = dataclasses.field(default_factory=dict)
    #: partial-restore continuations awaiting re-admission:
    #: ``req_id -> (kept_tokens, evicted_tail_tokens, cache_reg_or_None)``.
    #: The request sits in ``queue`` with its kept prefix still MAPPED
    #: (like the pinned prefix: resident but not running); admission
    #: re-prefills the tail through ``admit_forked_batch``.
    partial_resume: dict[int, tuple[int, np.ndarray, Any]] = (
        dataclasses.field(default_factory=dict))
    step_i: int = 0
    prefix_len: int = 0

    @property
    def num_tracked(self) -> int:
        """Requests this replica currently accounts for (conservation
        checks: submitted == queued + running + swapped + done)."""
        return (len(self.queue) + len(self.running) + len(self.swapped)
                + len(self.done))


@dataclasses.dataclass
class SwapExport:
    """Portable migration record for one spilled request — everything a
    DESTINATION replica needs to adopt the victim.

    ``record`` is the opaque plane-level swap payload (for the real
    executor: the switcher's :class:`~repro_torch.core.context_switch.
    SpilledState`, host bytes in the pool storage dtype — int8 records
    stay narrow).  ``shared_prefix_pages`` carries the pinned-prefix
    provenance as a COUNT, not frame ids: source frame ids mean nothing in
    another pool, so the importer re-resolves the claim against the
    *destination's* prefix mapping (its first k frames hold the same bytes
    under the fleet invariant that every preloaded prefix is identical).
    A destination without a prefix — or with a shorter one — simply
    shrinks the claim to zero and restores every page from the record,
    which carries ALL the victim's pages including the formerly-shared
    leading ones.
    """

    req: Request
    num_tokens: int
    shared_prefix_pages: int
    record: Any


@dataclasses.dataclass
class DecodePlan:
    """Full-slot decode batch: host arrays only, indexed by device slot.

    ``horizon`` is the number of chained decode steps the executor runs in
    one dispatch; ``steps_left[slot]`` is how many of those inner steps the
    lane participates in (it retires — stops writing KV, freezes its
    position — after that many, masked on device).  ``horizon == 1`` is
    exactly the pre-horizon single-step plan.
    """

    tokens: np.ndarray              # [B, ...] last sampled token per slot
    pre_lens: np.ndarray            # [B] position of the new token
    active: np.ndarray              # [B] bool — slots decoding this step
    horizon: int = 1                # fused inner decode steps this dispatch
    steps_left: np.ndarray | None = None   # [B] int32 active steps per lane


class DataPlane(Protocol):
    """The narrow device interface the scheduler drives.

    Implementations: :class:`repro_torch.serve.executor.Executor` (real device
    state) and :class:`HostOnlyPlane` (tests).  Every method is invoked at
    the exact point in the scheduling loop where the seed engine performed
    the equivalent device work, so policy decisions (which frames are free,
    who gets preempted) see identical allocator state.
    """

    def spill(self, req: Request) -> None:
        """Copy the victim's pages out, then free its mapping
        (``vmem.spill_seq``)."""
        ...

    def restore(self, req: Request, num_tokens: int,
                shared_pages: list[int] | None = None) -> None:
        """Re-map the sequence (``vmem.restore_seq``) and copy its pages
        back in.  ``shared_pages``: leading frames to re-share by refcount
        (still resident under the pinned prefix) instead of re-mapping —
        they are neither allocated nor copied."""
        ...

    def discard(self, req: Request) -> None:
        """Drop a spilled request's swap record without restoring it (the
        scheduler failed it); frees any host-side page copies."""
        ...

    def export_swap(self, req: Request) -> Any:
        """Detach ``req``'s swap record as a portable host-side payload
        (cross-replica migration source side).  After this the plane holds
        NOTHING for the request — the record rides the
        :class:`SwapExport`."""
        ...

    def import_swap(self, req: Request, record: Any) -> None:
        """Adopt a swap record exported from another replica's plane
        (migration destination side).  Must raise BEFORE any side effect
        on rejection, so the router can re-import at the source."""
        ...

    def admit_forked_batch(
        self, reqs: list[Request], start_lens: list[int],
        tail_copies: list[tuple[int, int] | None],
    ) -> list[Any]:
        """COW tail-page copies + ONE batched continuation prefill of all
        ``reqs[i].prompt`` chunks at offsets ``start_lens[i]``; returns the
        first sampled token per request (request order)."""
        ...

    # -- compute surface (lets Scheduler.step_plane drive a full engine
    # -- step against ANY plane: the Executor, a host stub, a fault fake)

    def prefill(self, reqs: list[Request]) -> list[Any]:
        """Batched prefill of freshly admitted requests; returns the first
        sampled token per request (request order)."""
        ...

    def decode(self, tokens: np.ndarray, pre_lens: np.ndarray,
               active: np.ndarray) -> np.ndarray:
        """One full-slot decode step; returns sampled tokens by slot."""
        ...

    def decode_multi(self, plan: DecodePlan) -> np.ndarray:
        """Fused K-step decode horizon; returns the ``[K, B, ...]`` token
        block (step-major)."""
        ...


class HostOnlyPlane:
    """Data-plane stub: page-table bookkeeping only, no arrays.

    Lets scheduler unit tests exercise admission order, victim policy and
    fork accounting on a bare :class:`VirtualMemory`.  Records every call
    in ``events`` for assertions.
    """

    def __init__(self, vmem: VirtualMemory):
        self.vmem = vmem
        self.events: list[tuple] = []

    def spill(self, req: Request) -> None:
        self.events.append(("spill", req.req_id))
        self.vmem.spill_seq(req.req_id)

    def restore(self, req: Request, num_tokens: int,
                shared_pages: list[int] | None = None) -> None:
        self.events.append(("restore", req.req_id))
        self.vmem.restore_seq(req.req_id, num_tokens, shared_pages)

    def discard(self, req: Request) -> None:
        self.events.append(("discard", req.req_id))

    def export_swap(self, req: Request):
        self.events.append(("export_swap", req.req_id))
        return ("swap_record", req.req_id)

    def import_swap(self, req: Request, record) -> None:
        self.events.append(("import_swap", req.req_id))

    def admit_forked_batch(self, reqs, start_lens, tail_copies):
        self.events.append(
            ("admit_forked_batch", [r.req_id for r in reqs])
        )
        for req, start, tail in zip(reqs, start_lens, tail_copies):
            self.events.append(("admit_forked", req.req_id, start, tail))
        return [np.int32(0)] * len(reqs)

    # compute surface: all-zero token streams, enough for step_plane loops

    def prefill(self, reqs):
        self.events.append(("prefill", [r.req_id for r in reqs]))
        return [np.int32(0)] * len(reqs)

    def decode(self, tokens, pre_lens, active):
        self.events.append(("decode", int(active.sum())))
        return np.zeros(np.shape(tokens), np.int32)

    def decode_multi(self, plan):
        self.events.append(("decode_multi", plan.horizon))
        return np.zeros((plan.horizon,) + np.shape(plan.tokens), np.int32)


class Scheduler:
    """Continuous-batching policy: queues, admission, preemption, forks.

    Mirrors the seed engine's policy decisions exactly (same admission
    order, same victim key ``(remaining, -arrival)``, same FIFO restore)
    so the refactored engine is token-for-token equivalent; only the data
    plane changed.
    """

    def __init__(self, cfg: ServeConfig, vmem: VirtualMemory,
                 cost: CostModel | None = None,
                 counters: PerfCounters | None = None,
                 replica_id: int = 0):
        self.cfg = cfg
        self.vmem = vmem
        self.cost = cost or CostModel()
        self.counters = counters or PerfCounters()
        #: every piece of per-replica mutable scheduling state lives here
        #: (the router holds N of these); the properties below keep the
        #: historical single-replica attribute surface intact.
        self.state = ReplicaState(replica_id=replica_id)
        #: shared-prefix ("system prompt") support: one resident sequence
        #: whose whole pages are refcount-shared into forked requests.
        self.PREFIX_ID = -1
        self.plane: DataPlane | None = None
        #: radix index over resident token runs — admission probes it and
        #: COW-maps matched whole pages (no fork API needed).  Eviction is
        #: wired to the vmem unmap hook so the trie tracks residency (and
        #: therefore refcount drops) automatically.
        self.prefix_cache: PrefixCache | None = (
            PrefixCache(cfg.page_size) if cfg.prefix_cache else None
        )
        if self.prefix_cache is not None:
            vmem.add_unmap_hook(self.prefix_cache.release)
        #: optional stream sink (an AsyncDetokenizer): every committed
        #: token of a stream_callback-bearing request is pushed here, AT
        #: the commit point, AFTER the timing stamps — so delivery lag
        #: can never skew TTFT/TPOT.
        self.stream = None

    def attach_plane(self, plane: DataPlane) -> None:
        self.plane = plane

    def attach_stream(self, stream) -> None:
        """Attach the async detokenize/stream sink (push-only duck type:
        ``stream.push(req, token, final)``)."""
        self.stream = stream

    def _emit(self, req: Request, token: Any, final: bool) -> None:
        if self.stream is not None and req.stream_callback is not None:
            self.stream.push(req, token, final)

    def _stamp_commit(self, req: Request, now: float) -> None:
        """Timing capture point: the host-visible commit of a sampled
        token (finish_prefill / _flush_forked / commit_decode) — NEVER
        the detokenize thread.  Also tracks the peak mapped footprint."""
        if req.t_first_token == 0.0:
            req.t_first_token = now
        req.t_last_token = now
        if self.vmem.has_seq(req.req_id):
            req.pages_peak = max(req.pages_peak,
                                 len(self.vmem.seq(req.req_id).pages))

    # ------------------------------------------------------------------
    # per-replica state (delegated to ReplicaState)
    # ------------------------------------------------------------------

    @property
    def replica_id(self) -> int:
        return self.state.replica_id

    @property
    def queue(self) -> deque[Request]:
        return self.state.queue

    @property
    def swapped(self) -> deque[int]:
        return self.state.swapped

    @property
    def running(self) -> dict[int, Request]:
        return self.state.running

    @property
    def done(self) -> dict[int, Request]:
        return self.state.done

    @property
    def slot_of(self) -> dict[int, int]:
        return self.state.slot_of

    @property
    def _swap_requests(self) -> dict[int, Request]:
        return self.state.swap_requests

    @property
    def _spilled_tokens(self) -> dict[int, int]:
        return self.state.spilled_tokens

    @property
    def step_i(self) -> int:
        return self.state.step_i

    @step_i.setter
    def step_i(self, v: int) -> None:
        self.state.step_i = v

    @property
    def prefix_len(self) -> int:
        return self.state.prefix_len

    @prefix_len.setter
    def prefix_len(self, v: int) -> None:
        self.state.prefix_len = v

    # ------------------------------------------------------------------
    # queue API
    # ------------------------------------------------------------------

    @property
    def has_work(self) -> bool:
        return bool(self.queue or self.running or self.swapped)

    def submit(self, req: Request) -> None:
        req.arrival = self.step_i
        if req.t_enqueue == 0.0:      # router may have stamped queue entry
            req.t_enqueue = time.perf_counter()
        self.queue.append(req)
        self.counters.inc("submitted")
        self.counters.snapshot("submit", req.req_id)

    def begin_step(self) -> None:
        self.step_i += 1
        if self.step_i % self.cfg.tick_every_steps == 0:
            # 100 Hz scheduler tick accounting (paper §3.1)
            self.counters.inc("ticks")
            self.counters.inc(
                "modeled_tick_cycles", self.cost.sched_tick_cycles
            )

    def step_plane(self) -> None:
        """One full engine step against the attached :class:`DataPlane`.

        The canonical serving step — restore, admit (+prefill), plan a
        fused horizon, decode, commit — factored out of ``Engine.step`` so
        the single-replica engine, the multi-replica router and the fake-
        plane test harnesses all drive the exact same loop.  Each replica
        of a router runs this independently; nothing here reads any state
        outside ``self``/the plane, which is what makes N replicas
        trivially isolated.
        """
        self.begin_step()
        self.try_restore()
        admitted = self.admit()
        if admitted:
            first = self.plane.prefill(admitted)
            self.finish_prefill(admitted, first)
        # plan_decode picks a fused horizon K (1 under pool pressure or
        # pending admissions/restores) and pre-faults every page K steps
        # will touch in one batched allocation
        plan = self.plan_decode()
        if plan is not None:
            if plan.horizon > 1:
                block = self.plane.decode_multi(plan)
                self.commit_decode(block, horizon=plan.horizon)
            else:
                sampled = self.plane.decode(
                    plan.tokens, plan.pre_lens, plan.active
                )
                self.commit_decode(sampled)

    # ------------------------------------------------------------------
    # reach checks (livelock prevention)
    # ------------------------------------------------------------------

    def attainable_pages(self) -> int:
        """Frames preemption could EVER free: the pool minus the DISTINCT
        physical frames pinned by the resident shared prefix (never a
        preemption victim).  Counted as a frame set, not per mapping —
        a frame refcount-shared into K running sequences is still ONE
        pinned frame, deducted once."""
        if self.vmem.has_seq(self.PREFIX_ID):
            pinned = len({int(p)
                          for p in self.vmem.seq(self.PREFIX_ID).pages})
        else:
            pinned = 0
        return self.vmem.pool.num_pages - pinned

    def _pinned_shared_pages(self, owner: int | None, matched: int) -> int:
        """Of the ``matched // page_size`` frames a radix hit would share
        from ``owner``, how many are PINNED-prefix frames.

        These frames already sit inside :meth:`attainable_pages`' pinned
        deduction, so counting them against the request's own demand
        would charge one physical frame once per sharer (the satellite-1
        accounting bug).  Frames shared with a *non-pinned* owner are NOT
        deducted: they must still coexist with the request's footprint
        inside the preemptible pool, so they legitimately count."""
        if not matched or owner is None:
            return 0
        if not (self.vmem.has_seq(owner)
                and self.vmem.has_seq(self.PREFIX_ID)):
            return 0
        pinned = set(self.vmem.seq(self.PREFIX_ID).pages)
        whole = matched // self.cfg.page_size
        return sum(1 for p in self.vmem.seq(owner).pages[:whole]
                   if p in pinned)

    def _admission_unreachable(self, req: Request, matched: int = 0,
                               owner: int | None = None) -> bool:
        """True if ``req`` could never run mapped to completion: its
        lifetime page demand (prompt + every future token, fork/radix
        sharing included) exceeds what preemption can ever free, or the
        page-table reach.  Admitting it ends either in a restore livelock
        (if it is ever spilled) or in a degraded scratch-routed decode
        tail — fail fast at admission instead.

        The demand counts each PHYSICAL frame once: frames shared with
        the pinned prefix (directly for forks, through the radix owner's
        leading pages for prefix hits) are already inside the
        :meth:`attainable_pages` deduction and cost the request nothing.
        """
        pf = self.vmem.config.pages_for
        # The FINAL sampled token is never grown into the table — the
        # request retires inside commit_decode — so the mapped lifetime is
        # one token short of prompt + max_new (floor: the first decode
        # position is always mapped, even for max_new == 1).
        gen = max(req.max_new_tokens, 2) - 1
        if req.share_prefix:
            lifetime = self.prefix_len + len(req.prompt) + gen
            shared = self.prefix_len // self.cfg.page_size
        else:
            lifetime = len(req.prompt) + gen
            shared = self._pinned_shared_pages(owner, matched)
        own = pf(lifetime) - shared
        return (lifetime > self.vmem.config.max_tokens_per_seq
                or own > self.attainable_pages())

    def _fail(self, req: Request, reason: str) -> None:
        """Terminal parking for a request that can never fit (reach check):
        surfaced through ``done`` with status ``failed`` so callers see it
        and ``run()`` terminates instead of spinning until ``max_steps``."""
        req.status = "failed"
        req.t_last_token = time.perf_counter()
        if req.t_first_token == 0.0:
            req.t_first_token = req.t_last_token
        self.done[req.req_id] = req
        self.counters.inc("failed_unreachable")
        self.counters.snapshot("failed_" + reason, req.req_id)
        # streams always terminate: a failed request still gets a final
        # event (token=None) so a client waiting on `final` never hangs
        self._emit(req, None, final=True)

    # ------------------------------------------------------------------
    # restore (swap-in)
    # ------------------------------------------------------------------

    def _restorable_shared(self, req_id: int) -> list[int]:
        """The spill-time pinned-prefix frames of ``req_id`` that are
        STILL the prefix's leading frames — the portion of a restore that
        re-shares by refcount instead of allocating.  Validated against
        the live prefix mapping each call, so a stale provenance record
        can only shrink the claim, never corrupt a restore."""
        shared = self.state.spilled_shared.get(req_id)
        if not shared or not self.vmem.has_seq(self.PREFIX_ID):
            return []
        pre = self.vmem.seq(self.PREFIX_ID).pages
        if len(shared) <= len(pre) and shared == pre[:len(shared)]:
            return list(shared)
        return []

    def can_restore(self, req_id: int) -> bool:
        if req_id not in self._spilled_tokens:
            return False
        need = (self.vmem.config.pages_for(self._spilled_tokens[req_id])
                - len(self._restorable_shared(req_id)))
        return (self.vmem.pool.num_free >= need
                and self.vmem.num_free_slots > 0)

    def _commit_restore(self, req_id: int, req: Request,
                        shared: list[int]) -> None:
        """Shared tail of every successful full restore (the caller has
        already removed ``req_id`` from the ``swapped`` deque)."""
        del self._swap_requests[req_id]
        del self._spilled_tokens[req_id]
        self.state.spilled_shared.pop(req_id, None)
        self.state.restore_blocked.pop(req_id, None)
        if shared:
            self.counters.inc("shared_restores")
            self.counters.inc("pages_reused", len(shared))
        req.status = "running"
        self.running[req_id] = req
        self.slot_of[req_id] = self.vmem.seq(req_id).slot
        self.counters.inc("restores")
        self.counters.snapshot("restore", req_id)

    def try_restore(self) -> list[Request]:
        restored: list[Request] = []
        for _ in range(len(self.swapped)):
            req_id = self.swapped[0]
            # Reach check, re-evaluated on every pass: the victim's
            # pinned-prefix-shared run restores by RE-SHARING the still-
            # resident frames (no fresh allocation), so only the unshared
            # remainder demands frames preemption could free.  Only when
            # that remainder can never fit is the victim truly
            # unreachable — otherwise the FIFO head would block the swap
            # queue until ``run(max_steps)`` expires (the ROADMAP
            # livelock) — fail it then, and only then.  (Under a router
            # the migration sweep runs FIRST, so this verdict only lands
            # when no replica can host the adjusted demand.)
            shared = self._restorable_shared(req_id)
            need = (self.vmem.config.pages_for(self._spilled_tokens[req_id])
                    - len(shared))
            if need > self.attainable_pages():
                self.swapped.popleft()
                self._spilled_tokens.pop(req_id)
                self.state.spilled_shared.pop(req_id, None)
                self.state.restore_blocked.pop(req_id, None)
                req = self._swap_requests.pop(req_id)
                self.plane.discard(req)    # free the host-side swap record
                self._fail(req, "restore")
                continue
            if len(self.running) >= self.cfg.max_batch:
                break
            if not self.can_restore(req_id):
                # Capacity-blocked head: strict FIFO wait, but after
                # ``restore_patience`` consecutive blocked passes stop
                # waiting for the all-or-nothing restore and bring back
                # the longest page-aligned prefix that fits RIGHT NOW
                # (the evicted tail re-prefills through the continuation
                # path once admission finds it pages — with preemption
                # power a restore never has).
                blocked = self.state.restore_blocked.get(req_id, 0) + 1
                self.state.restore_blocked[req_id] = blocked
                if (self.cfg.restore_patience > 0
                        and blocked >= self.cfg.restore_patience
                        and self._try_partial_restore(req_id, shared)):
                    continue
                break
            req = self._swap_requests[req_id]
            try:
                self.plane.restore(req, self._spilled_tokens[req_id],
                                   shared_pages=shared or None)
            except RestoreFailure:
                # Transient data-plane failure, raised before any side
                # effect (the RestoreFailure contract): leave the victim
                # at the FIFO head and retry on a later step — but give
                # the victims queued BEHIND it a bounded second chance,
                # or a head pinned to a failing plane starves the queue.
                self.counters.inc("restore_failures")
                self.counters.snapshot("restore_failure", req_id)
                self._second_chance_scan(restored)
                break
            self.swapped.popleft()
            self._commit_restore(req_id, req, shared)
            restored.append(req)
        return restored

    def _second_chance_scan(self, restored: list[Request]) -> None:
        """Bounded scan past a ``RestoreFailure``-blocked FIFO head
        (mirroring the admission scan's bounded look-ahead): fully restore
        up to ``restore_scan_limit`` later victims that fit, WITHOUT
        popping the head — it keeps its FIFO position and retries first on
        the next pass, so completion-order guarantees never invert, the
        queue just stops starving behind one pinned victim."""
        scanned = 0
        i = 1
        while i < len(self.swapped) and scanned < self.cfg.restore_scan_limit:
            if len(self.running) >= self.cfg.max_batch:
                break
            req_id = self.swapped[i]
            scanned += 1
            if not self.can_restore(req_id):
                i += 1
                continue
            shared = self._restorable_shared(req_id)
            req = self._swap_requests[req_id]
            try:
                self.plane.restore(req, self._spilled_tokens[req_id],
                                   shared_pages=shared or None)
            except RestoreFailure:
                self.counters.inc("restore_failures")
                self.counters.snapshot("restore_failure", req_id)
                i += 1
                continue
            del self.swapped[i]
            self._commit_restore(req_id, req, shared)
            self.counters.inc("second_chance_restores")
            restored.append(req)

    def _try_partial_restore(self, req_id: int, shared: list[int]) -> bool:
        """Restore the longest page-aligned prefix of the FIFO-head victim
        that fits the pool now (re-sharing ``shared`` pinned frames),
        consume its swap record, and re-enqueue the request at the queue
        FRONT as a partial-resume continuation — admission re-prefills the
        evicted tail through ``admit_forked_batch`` (causal KV is a pure
        function of the token prefix, so the recompute is exact) and drops
        the recomputed chunk's sampled token, which the stream already
        carries.  Returns False (leaving full-restore waiting in place)
        whenever the tail is not host-reconstructable or nothing useful
        fits."""
        if (self.state.partial_resume      # one outstanding continuation:
                # stacked kept-but-idle mappings could exhaust the pool
                # with nothing running (hence nothing preemptible)
                or self.vmem.num_free_slots <= 0
                or len(self.running) >= self.cfg.max_batch
                or np.ndim(self._swap_requests[req_id].prompt) != 1):
            return False
        page = self.cfg.page_size
        req = self._swap_requests[req_id]
        spilled = self._spilled_tokens[req_id]
        total_pages = self.vmem.config.pages_for(spilled)
        keep_pages = min(len(shared) + self.vmem.pool.num_free,
                         total_pages - 1)
        keep = keep_pages * page
        base = req.prefix_len
        # the tail must be reconstructable from prompt+output alone —
        # positions below prefix_len belong to the (fork/radix) parent
        if (keep_pages < 1 or keep_pages < len(shared) or keep < base
                or keep >= spilled):
            return False
        try:
            stream = np.concatenate([
                np.asarray(req.prompt, np.int32).reshape(-1),
                np.asarray([int(np.asarray(t)) for t in req.output],
                           np.int32),
            ])
        except (TypeError, ValueError, OverflowError):
            return False
        if spilled - base > len(stream):
            return False
        tail = stream[keep - base: spilled - base]
        if tail.size == 0:
            return False
        try:
            self.plane.restore(req, keep, shared_pages=shared or None)
        except RestoreFailure:
            self.counters.inc("restore_failures")
            self.counters.snapshot("restore_failure", req_id)
            return False
        # full committed content, for re-registering the restored run
        # with the radix cache at resume time (best effort: a fork's
        # leading positions come from the registered prefix tokens)
        reg = None
        if self.prefix_cache is not None:
            if base == 0:
                reg = stream[:spilled]
            else:
                pre = self.prefix_cache.tokens_of(self.PREFIX_ID)
                if (req.share_prefix and pre is not None
                        and np.ndim(pre) == 1 and len(pre) >= base):
                    reg = np.concatenate(
                        [np.asarray(pre, np.int32)[:base], stream]
                    )[:spilled]
        self.swapped.popleft()
        del self._swap_requests[req_id]
        del self._spilled_tokens[req_id]
        self.state.spilled_shared.pop(req_id, None)
        self.state.restore_blocked.pop(req_id, None)
        if shared:
            self.counters.inc("shared_restores")
            self.counters.inc("pages_reused", len(shared))
        req.status = "queued"
        self.state.partial_resume[req_id] = (keep, tail, reg)
        self.queue.appendleft(req)     # keeps the victim's FIFO priority
        self.counters.inc("partial_restores")
        self.counters.snapshot("partial_restore", (req_id, keep))
        return True

    # ------------------------------------------------------------------
    # cross-replica swap migration (router-driven)
    # ------------------------------------------------------------------

    def export_swapped(self, req_id: int) -> SwapExport:
        """Detach a spilled victim for migration to another replica: pops
        every piece of swap bookkeeping AND the plane's swap record, so
        this replica keeps no reference (the satellite leak audit's
        migration-source path).  The pinned-prefix provenance travels as a
        page COUNT — the destination re-resolves it against its own prefix
        mapping (:meth:`import_swapped`)."""
        if req_id not in self._swap_requests:
            raise KeyError(f"req {req_id} is not swapped on replica "
                           f"{self.replica_id}")
        self.swapped.remove(req_id)
        req = self._swap_requests.pop(req_id)
        num_tokens = self._spilled_tokens.pop(req_id)
        k = len(self.state.spilled_shared.pop(req_id, []) or [])
        self.state.restore_blocked.pop(req_id, None)
        record = self.plane.export_swap(req)
        self.counters.inc("swap_exports")
        return SwapExport(req=req, num_tokens=num_tokens,
                          shared_prefix_pages=k, record=record)

    def import_swapped(self, exp: SwapExport, front: bool = False) -> None:
        """Adopt a migrated victim: hand the plane its swap record (which
        must raise BEFORE side effects on rejection — the router then
        re-imports at the source) and re-resolve the pinned-prefix claim
        against THIS replica's prefix: its first k whole pages hold the
        same bytes as the source prefix's under the fleet invariant that
        preloaded prefixes are identical; a missing/shorter prefix just
        shrinks the claim and the restore moves those pages from the
        record instead.  ``front=True`` preserves FIFO priority (rollback
        re-imports at the source head)."""
        rid = exp.req.req_id
        self.plane.import_swap(exp.req, exp.record)   # may raise: no-op then
        exp.req.status = "swapped"
        if front:
            self.swapped.appendleft(rid)
        else:
            self.swapped.append(rid)
        self._swap_requests[rid] = exp.req
        self._spilled_tokens[rid] = exp.num_tokens
        shared: list[int] = []
        k = exp.shared_prefix_pages
        if k and self.vmem.has_seq(self.PREFIX_ID):
            pre = self.vmem.seq(self.PREFIX_ID).pages
            if k <= min(len(pre), self.prefix_len // self.cfg.page_size):
                shared = [int(p) for p in pre[:k]]
        self.state.spilled_shared[rid] = shared
        self.counters.inc("swap_imports")

    # ------------------------------------------------------------------
    # preemption (context-switch policy)
    # ------------------------------------------------------------------

    def select_victim(self, protect: int | None = None) -> Request | None:
        """Policy: most remaining work (cheapest to delay), oldest last."""
        victims = [r for rid, r in self.running.items() if rid != protect]
        if not victims:
            return None
        return max(victims, key=lambda r: (r.remaining, -r.arrival))

    def preempt_for(self, pages_needed: int,
                    protect: int | None = None) -> bool:
        """Spill victims until ``pages_needed`` frames are free."""
        while self.vmem.pool.num_free < pages_needed:
            victim = self.select_victim(protect)
            if victim is None:
                return False
            self.spill(victim)
        return True

    def _pinned_prefix_frames(self, req_id: int) -> list[int]:
        """Leading frames of ``req_id`` that ARE the pinned prefix's frames
        (positionally identical — fork and radix sharing both preserve the
        logical page index).  Whole shared pages are immutable while
        refcounted and the prefix is never unmapped, so these frames stay
        resident with identical bytes for the life of the engine: a later
        restore may re-share them instead of demanding fresh frames."""
        if not (self.vmem.has_seq(self.PREFIX_ID)
                and self.vmem.has_seq(req_id)):
            return []
        own = self.vmem.seq(req_id).pages
        pre = self.vmem.seq(self.PREFIX_ID).pages
        k = 0
        while k < min(len(own), len(pre)) and own[k] == pre[k]:
            k += 1
        return [int(p) for p in own[:k]]

    def spill(self, victim: Request) -> None:
        self._spilled_tokens[victim.req_id] = self.vmem.seq_len(victim.req_id)
        # provenance BEFORE the plane frees the mapping: which leading
        # frames were pinned-prefix shares (restorable by re-sharing)
        self.state.spilled_shared[victim.req_id] = (
            self._pinned_prefix_frames(victim.req_id)
        )
        self.plane.spill(victim)       # copies pages out + frees the mapping
        victim.status = "swapped"
        self.swapped.append(victim.req_id)
        self._swap_requests[victim.req_id] = victim
        del self.running[victim.req_id]
        del self.slot_of[victim.req_id]
        self.counters.inc("preemptions")
        self.counters.snapshot("preempt", victim.req_id)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def required_pages(self, req: Request) -> int:
        return self.vmem.config.pages_for(len(req.prompt) + 1)

    def probe_prefix(self, req: Request) -> tuple[int, int | None]:
        """Longest radix-cached resident prefix a cold admission of
        ``req`` could COW-share: ``(matched_tokens, owner_seq_id)``.

        Page-aligned, capped so at least one prompt token survives as the
        continuation chunk (its logits seed the first sampled token), and
        validated against the owner's live mapping.  ``(0, None)`` for
        explicit forks (they share through the fork path) and on a miss.
        Pure — safe for the router to call when ranking replicas.
        """
        if (self.prefix_cache is None or req.share_prefix
                or req.prefix_len or len(req.prompt) <= 1):
            return 0, None
        matched, owner = self.prefix_cache.match(req.prompt)
        cap = ((len(req.prompt) - 1) // self.cfg.page_size
               ) * self.cfg.page_size
        matched = min(matched, cap)
        if matched <= 0 or owner is None:
            return 0, None
        if not self.vmem.has_seq(owner) \
                or self.vmem.seq_len(owner) < matched:
            return 0, None
        return matched, owner

    def register_resident(self, seq_id: int, tokens: np.ndarray) -> None:
        """Index an already-committed resident run in the radix cache
        (``Engine.preload_prefix`` calls this for the pinned system
        prefix after its KV is written)."""
        if self.prefix_cache is not None:
            self.prefix_cache.register(seq_id, np.asarray(tokens))

    def admit(self) -> list[Request]:
        """Pop queue-front requests that fit; returns the plain-prefill
        batch.  Forked requests — and radix prefix hits, which reuse the
        same COW machinery — have their page tables forked inline (so
        allocator state evolves in the same order as the seed engine) but
        their continuation prefills are accumulated and issued as ONE
        batched data-plane call per step (``admit_forked_batch``)."""
        admitted: list[Request] = []
        pending: list[
            tuple[Request, int, tuple[int, int] | None, Any,
                  Request | None]] = []
        while self.queue and (
            len(self.running) + len(admitted) + len(pending)
            < self.cfg.max_batch
        ):
            req = self.queue[0]
            if req.req_id in self.state.partial_resume:
                # partial-restore continuation: the kept prefix is already
                # mapped; only the evicted tail needs frames — and HERE the
                # request holds preemption power an in-place restore never
                # had (the whole point of re-enqueueing it).  No reach
                # check: the tail demand is strictly below the admission
                # demand that already passed.
                keep, tail, _ = self.state.partial_resume[req.req_id]
                need = (self.vmem.config.pages_for(keep + len(tail))
                        - len(self.vmem.seq(req.req_id).pages))
                if need > self.vmem.pool.num_free:
                    self._flush_forked(pending)
                    if not self.preempt_for(need, protect=req.req_id):
                        break              # retried at the head next step
                entry = self._resume_bookkeeping(req)
                if entry is None:
                    break
                pending.append(entry)
                self.queue.popleft()
                continue
            matched, owner = self.probe_prefix(req)
            if self._admission_unreachable(req, matched, owner):
                self.queue.popleft()
                self._fail(req, "admit")
                continue
            if matched:
                # the matched whole pages arrive by refcount, not
                # allocation — only the divergent remainder needs frames
                need = (self.required_pages(req)
                        - matched // self.cfg.page_size)
            else:
                need = self.required_pages(req)
            if need > self.vmem.pool.num_free:
                # pending forks must be committed (running) before victim
                # selection so they are preemptible, like the seed's inline
                # admission order
                self._flush_forked(pending)
                if not self.preempt_for(
                        need, protect=owner if matched else None):
                    break                      # nothing left to preempt
            if req.share_prefix:
                entry = self._fork_bookkeeping(req)
                if entry is None:
                    break
                pending.append(entry)
                self.queue.popleft()
                continue
            if matched:
                entry = self._radix_bookkeeping(req, matched, owner)
                if entry is not None:
                    pending.append(entry)
                    self.queue.popleft()
                    continue
                # hit could not be honored (owner raced away / pool
                # exhausted mid-fork): fall through to cold admission
            try:
                self.vmem.map_seq(req.req_id, len(req.prompt))
            except OutOfPagesError:
                break
            self.queue.popleft()
            admitted.append(req)
        self._flush_forked(pending)
        return admitted

    def _resume_bookkeeping(
        self, req: Request
    ) -> tuple[Request, int, tuple[int, int] | None, Any, Request] | None:
        """Map the evicted tail of a partial-restore continuation and build
        its pending entry.  The plane prefills a SHADOW request (the tail
        as prompt, the kept length as prefix) so the real request's
        prompt/output — and therefore ``total_len`` and the committed
        stream — stay untouched; ``_flush_forked`` discards the shadow's
        sampled token, which position arithmetic shows is exactly the last
        committed ``output`` entry (logits at position spilled-1 sample
        position spilled)."""
        keep, tail, reg = self.state.partial_resume[req.req_id]
        try:
            faults = self.vmem.append_tokens(req.req_id, int(len(tail)))
        except OutOfPagesError:
            return None                    # entry stays; retried next step
        del self.state.partial_resume[req.req_id]
        self.counters.inc("pages_refilled", len(faults))
        shadow = dataclasses.replace(
            req, prompt=np.asarray(tail, np.int32), prefix_len=keep,
            output=[], stream_callback=None)
        return (shadow, keep, None, reg, req)

    def _fork_bookkeeping(
        self, req: Request
    ) -> tuple[Request, int, tuple[int, int] | None, Any,
               Request | None] | None:
        """Fork the resident prefix's page table for ``req`` (host state
        only — the data-plane call is deferred to ``_flush_forked``)."""
        page = self.cfg.page_size
        try:
            state = self.vmem.fork_seq(self.PREFIX_ID, req.req_id,
                                       self.prefix_len)
        except OutOfPagesError:
            return None
        tail_copy: tuple[int, int] | None = None
        if self.prefix_len % page:
            # partial tail page is copied; whole pages are shared read-only
            tail_idx = self.prefix_len // page
            parent = self.vmem.seq(self.PREFIX_ID)
            tail_copy = (parent.pages[tail_idx], state.pages[tail_idx])
        try:
            self.vmem.append_tokens(req.req_id, len(req.prompt))
        except OutOfPagesError:
            self.vmem.unmap_seq(req.req_id)    # roll the fork back cleanly
            return None
        self.counters.inc("forked_admissions")
        # the child's committed content is prefix+prompt; register it so
        # later admissions can radix-match THROUGH the fork (content known
        # only if the prefix itself was registered)
        reg = None
        if self.prefix_cache is not None:
            pre = self.prefix_cache.tokens_of(self.PREFIX_ID)
            if pre is not None and np.ndim(pre) == np.ndim(req.prompt):
                try:
                    reg = np.concatenate(
                        [np.asarray(pre)[:self.prefix_len], req.prompt])
                except ValueError:
                    reg = None
        return (req, self.prefix_len, tail_copy, reg, None)

    def _radix_bookkeeping(
        self, req: Request, matched: int, owner: int
    ) -> tuple[Request, int, tuple[int, int] | None, Any,
               Request | None] | None:
        """COW-map the radix-matched whole pages of ``owner`` for ``req``
        (host state only — the continuation prefill is deferred to
        ``_flush_forked``).  ``req.prompt`` is sliced to the unmatched
        chunk and ``prefix_len`` takes the matched length, so every
        downstream length computation (``total_len``, decode positions,
        the continuation offsets) is the forked-admission arithmetic
        unchanged.  Returns None when the hit cannot be honored — the
        caller falls back to cold admission."""
        if not self.vmem.has_seq(owner) \
                or self.vmem.seq_len(owner) < matched:
            return None
        full = req.prompt
        try:
            # page-aligned: shares matched//page_size whole pages, no tail
            self.vmem.fork_seq(owner, req.req_id, matched)
        except OutOfPagesError:
            return None
        try:
            self.vmem.append_tokens(req.req_id, len(full) - matched)
        except OutOfPagesError:
            self.vmem.unmap_seq(req.req_id)    # roll the fork back cleanly
            return None
        req.prompt = full[matched:]
        self.counters.inc("prefix_hits")
        self.counters.inc("pages_reused", matched // self.cfg.page_size)
        self.counters.inc("prefill_tokens_skipped", matched)
        self.counters.snapshot("prefix_hit", (req.req_id, matched))
        return (req, matched, None, full, None)

    def _flush_forked(
        self,
        pending: list[tuple[Request, int, tuple[int, int] | None, Any,
                            Request | None]],
    ) -> None:
        """Run all pending forked/radix-hit admissions — and partial-
        restore continuations — as ONE batched continuation prefill and
        commit them to ``running`` (request order).  Each entry's
        registration tokens (the request's full committed content) enter
        the radix cache only HERE — after the plane call wrote the chunk's
        KV — so a same-step admission can never match pages whose KV is
        not yet committed.

        Resume entries (5th element set) prefilled a SHADOW request: the
        REAL request goes running with its stream untouched, and the
        shadow's sampled token is dropped — the recomputed chunk ends at
        position ``spilled-1``, whose logits sample position ``spilled``,
        a token the stream committed before the spill."""
        if not pending:
            return
        reqs = [e[0] for e in pending]
        firsts = self.plane.admit_forked_batch(
            reqs, [e[1] for e in pending], [e[2] for e in pending]
        )
        now = time.perf_counter()
        for (req, start_len, _, reg, orig), first in zip(pending, firsts):
            if orig is not None:
                req = orig                  # commit the REAL request;
                                            # `first` is discarded (above)
            else:
                req.prefix_len = start_len
                req.output.append(first)
            req.status = "running"
            self.running[req.req_id] = req
            self.slot_of[req.req_id] = self.vmem.seq(req.req_id).slot
            if reg is not None and self.prefix_cache is not None:
                self.prefix_cache.register(req.req_id, reg)
            self._stamp_commit(req, now)
            if orig is None:
                self._emit(req, req.output[-1], final=False)
        self.counters.inc("fork_batches")
        pending.clear()

    def finish_prefill(self, reqs: list[Request], first_tokens: Any) -> None:
        """Commit a plain-prefill batch: mark running, record accounting.
        The prompts enter the radix cache here — the plane call that
        committed their KV has completed."""
        now = time.perf_counter()
        for i, r in enumerate(reqs):
            r.status = "running"
            r.output.append(np.asarray(first_tokens[i]))
            self.running[r.req_id] = r
            self.slot_of[r.req_id] = self.vmem.seq(r.req_id).slot
            if self.prefix_cache is not None:
                self.prefix_cache.register(r.req_id, r.prompt)
            self._stamp_commit(r, now)
            self._emit(r, r.output[-1], final=False)
        lens = [len(r.prompt) for r in reqs]
        self.counters.inc("prefill_tokens", int(sum(lens)))
        self.counters.inc("prefill_translation_bursts", int(
            sum(self.vmem.config.pages_for(int(x)) for x in lens)
        ))
        self.counters.snapshot("prefill", [r.req_id for r in reqs])

    # ------------------------------------------------------------------
    # decode planning
    # ------------------------------------------------------------------

    def grow_running(self) -> None:
        """Fault in pages for every running sequence's next position,
        preempting victims when the pool is exhausted (idempotent: a
        restore may already cover the position)."""
        for req_id in list(self.running):
            r = self.running.get(req_id)
            if r is None:
                continue  # spilled by an earlier victim selection this step
            grow = r.total_len - self.vmem.seq_len(req_id)
            if grow <= 0:
                continue
            try:
                faults = self.vmem.append_tokens(req_id, grow)
            except OutOfPagesError:
                if not self.preempt_for(1, protect=req_id):
                    # Stays running; retried next step.  Decode proceeds
                    # anyway (seed semantics): the executor routes writes
                    # at unmapped positions to the scratch frame, so the
                    # request keeps producing tokens and terminates — this
                    # is degraded, not deadlocked.  (The genuinely
                    # unterminating cases — admission and restore of
                    # requests whose demand can never be met — are failed
                    # by the reach checks above.)
                    continue
                faults = self.vmem.append_tokens(req_id, grow)
            if faults:
                self.counters.inc("page_faults", len(faults))
                self.counters.inc(
                    "modeled_fault_cycles",
                    len(faults) * (self.cost.ptw_cycles
                                   + self.cost.post_fault_flush_cycles),
                )

    @staticmethod
    def _steps_until_retire(r: Request) -> int:
        """Decode steps before ``r`` retires: it commits one token per step
        and retires when ``len(output) >= max_new_tokens`` — checked AFTER
        the append, so even a satisfied request decodes once more (seed
        semantics; the reason the floor is 1)."""
        return max(1, r.remaining)

    def plan_horizon(self) -> int:
        """Safe fused-decode horizon K for this step (pure policy — no
        allocation happens here).

        The scalar/OS plane may stay off the data path for K tokens iff no
        scheduler event can become due mid-horizon: pending admissions and
        restores collapse K to 1, because every retirement changes the
        slot/frame availability their policy reads.  Otherwise K is capped
        by the longest-living lane (shorter lanes retire mid-horizon inside
        the fused step, masked on device) and rounded down to a power of
        two so the executor's jit cache stays O(log max_horizon).
        """
        if self.cfg.max_horizon <= 1 or not self.running:
            return 1
        if self.queue or self.swapped:
            return 1
        k = min(
            self.cfg.max_horizon,
            max(self._steps_until_retire(r) for r in self.running.values()),
        )
        return 1 << (k.bit_length() - 1)

    def grow_horizon(self, horizon: int) -> int:
        """Pre-fault every page a K-step fused decode will touch, as ONE
        all-or-nothing batched allocation (one dirty-row flush when the
        executor syncs).  Returns the horizon actually in effect: under
        pool pressure (or a reach breach) it collapses to 1 and the
        per-step fault path — :meth:`grow_running`, with its preemption
        fallback — reproduces pre-horizon behavior exactly."""
        if horizon <= 1:
            self.grow_running()
            return 1
        grows: list[tuple[int, int]] = []
        for req_id, r in self.running.items():
            steps = min(horizon, self._steps_until_retire(r))
            # a retiring lane's FINAL sampled token is never mapped (it
            # retires inside commit_decode), hence the -1
            target = r.total_len + steps - 1
            grow = target - self.vmem.seq_len(req_id)
            if grow > 0:
                grows.append((req_id, grow))
        try:
            faults = self.vmem.append_tokens_batch(grows)
        except (OutOfPagesError, ValueError):
            self.counters.inc("horizon_collapses")
            self.grow_running()
            return 1
        if faults:
            self.counters.inc("page_faults", len(faults))
            self.counters.inc(
                "modeled_fault_cycles",
                len(faults) * (self.cost.ptw_cycles
                               + self.cost.post_fault_flush_cycles),
            )
        return horizon

    def plan_decode(self) -> DecodePlan | None:
        """One call per engine step: pick the horizon, fault in every page
        it needs, and build the decode plan (what ``Engine.step`` drives)."""
        k = self.grow_horizon(self.plan_horizon())
        return self.decode_plan(k)

    def decode_plan(self, horizon: int = 1) -> DecodePlan | None:
        if not self.running:
            return None  # everything got preempted this step
        b = self.cfg.max_batch
        sample = next(iter(self.running.values())).output[-1]
        tokens = np.zeros((b,) + np.shape(sample), np.int32)
        pre_lens = np.zeros((b,), np.int32)
        active = np.zeros((b,), bool)
        steps_left = np.zeros((b,), np.int32)
        for req_id, r in self.running.items():
            slot = self.slot_of[req_id]
            tokens[slot] = r.output[-1]
            pre_lens[slot] = r.total_len - 1   # position of the new token
            active[slot] = True
            steps_left[slot] = min(horizon, self._steps_until_retire(r))
        return DecodePlan(tokens=tokens, pre_lens=pre_lens, active=active,
                          horizon=horizon, steps_left=steps_left)

    def commit_decode(self, sampled: np.ndarray, horizon: int = 1) -> None:
        """Append sampled tokens (indexed by slot), retire finished
        requests.

        ``horizon == 1``: ``sampled`` is the single-step ``[B, ...]`` slot
        array.  ``horizon > 1``: ``sampled`` is the fused ``[K, B, ...]``
        token block; it is committed step-major — inner step t for every
        lane before step t+1 — so retirement order (and therefore the
        slot/frame free order the allocator sees) matches a K=1 run
        exactly.  A lane stops consuming the block the moment it retires;
        later block rows for that slot are device scratch output.
        """
        block = sampled if horizon > 1 else [sampled]
        for t in range(horizon):
            if not self.running:
                break
            if t:
                # the fused dispatch compressed K token-steps into one
                # engine step; advance the scheduler's logical clock per
                # inner step so step_i, the 100 Hz tick accounting and
                # run() budgets stay in TOKEN-steps — identical to a K=1
                # run of the same workload
                self.begin_step()
            self.counters.inc("decode_tokens", len(self.running))
            self.counters.inc("decode_translations", len(self.running))
            now = time.perf_counter()
            for req_id in list(self.running):
                r = self.running[req_id]
                slot = self.slot_of[req_id]
                r.output.append(np.asarray(block[t][slot]))
                # SLO timing capture point: the host-visible commit of
                # this token — stamped BEFORE the async stream push, so
                # detokenize lag cannot skew TTFT/TPOT
                self._stamp_commit(r, now)
                retired = len(r.output) >= r.max_new_tokens
                if retired:
                    r.status = "done"
                    self.done[req_id] = r
                    del self.running[req_id]
                    del self.slot_of[req_id]
                    self.vmem.unmap_seq(req_id)
                    self.counters.inc("completed")
                    self.counters.snapshot("done", req_id)
                self._emit(r, r.output[-1], final=retired)

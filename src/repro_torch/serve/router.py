"""Multi-replica serving control plane: one admission front-end, N planes.

Port of ``src/repro/serve/router.py``: host policy only, over the port's
:class:`~repro_torch.serve.scheduler.Scheduler`.  Ara2 (Perotti et al.,
2023) scales the Ara lane datapath to multi-core by replicating the
compute fabric behind one shared front-end; AraOS's claim is that the
shared translation/OS structure stays off the datapath's critical path
while it does.  A :class:`ReplicaRouter` owns the **global admission
queue** and places requests across N replicas — each a ``Scheduler``
(per-replica policy, its own ``ReplicaState``) driving its own
``DataPlane`` (an :class:`~repro_torch.serve.executor.Executor` on the
card, or a test fake).  Replicas share **no mutable state**: page pools,
KV pools, page tables, captured CUDA graphs, swap records and step clocks
are all per-replica (N engines may share one model and one weight set,
which no step writes), so the router is pure placement policy over N
independent single-replica engines, and the single-replica engine is
exactly the ``N=1`` instance of this layering.

Placement policies (``policy=``):

``least_loaded``
    Fewest committed-plus-backlogged pages (frames in use + the page
    demand of requests already queued on the replica); ties break toward
    the lowest replica id.  The default.
``round_robin``
    Cyclic over replicas, skipping ineligible ones.

**Fork affinity** is a correctness constraint layered on both: a
``share_prefix`` request COW-forks the resident prefix's page table, and
those shared pages live in ONE replica's pool — so forks are only placed
on a replica holding the prefix.  When the constraint overrides the base
policy's unconstrained choice, the router counts a
``migrations_declined``.

**Prefix-aware ranking**: for plain requests each candidate replica is
probed (``Scheduler.probe_prefix``) for the longest radix-cached resident
prefix of the prompt.  Under ``least_loaded`` the matched page count is
subtracted from the replica's load; under ``round_robin`` the cycle is
restricted to the replicas with the maximal match whenever any matches.
It is a *score*, not a constraint.  Placements where the score changed
the base policy's choice are counted as ``prefix_routed``.

**Cross-replica swap migration** (``migrate=True``, the default; inert at
N=1): swap records are portable (``SwapExport`` — host bytes in the pool
storage dtype plus the pinned-prefix provenance as a page COUNT).  Once
per router step, BEFORE the replicas run, the router sweeps each
replica's swap-FIFO head and migrates it when (a) the source would fail
it as restore-unreachable but another replica's prefix-adjusted demand
fits (*rescue* — the scheduler's "fail as unreachable" verdict then
lands only when NO replica can ever host it), or (b) it has sat
capacity-blocked for ``migrate_after`` router steps and another replica
can restore it immediately (*starvation*).  Pinned-prefix re-sharing is
re-resolved against the DESTINATION's prefix mapping.  An import the
destination plane rejects (raised before side effects, per the
DataPlane contract) rolls back with a front-of-FIFO re-import at the
source, counted as ``migration_aborts``.  Migration also makes placement
REACH-AWARE: replicas whose attainable pool can never host a request's
lifetime demand are filtered out of the candidate set
(``reach_redirects``).

On the card a migrated record's bytes enter the destination's pools at
its restore (``ContextSwitcher.restore_kv``: fresh frames, one
``index_copy_`` per pool, in place), and the destination's page-table
delta uploads before its next step replays a graph.

Counters (router-global, in ``router.counters``): ``submitted``,
``placements``, ``placements_replica{i}``, ``migrations_declined``,
``prefix_routed``, ``restore_migrations``, ``migration_aborts``,
``reach_redirects``, ``cross_replica_queue_waits``.  Each replica's
scheduler/executor counters stay per-replica (migration adds
``swap_exports``/``swap_imports`` there); ``global_counters()`` merges
them, and every merged total equals the sum of the per-replica values.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from collections import deque
from typing import Any

from repro_torch.core import PerfCounters
from repro_torch.serve.api import ServeRequest, ServeResult
from repro_torch.serve.engine import _lower
from repro_torch.serve.scheduler import DataPlane, Request, Scheduler


@dataclasses.dataclass(eq=False)     # identity semantics: list.index / in
class Replica:
    """One model replica: a policy plane bound to its data plane.

    ``scheduler.counters`` must be the SAME object the plane increments
    (the :class:`~repro_torch.serve.engine.Engine` wiring), so per-replica
    accounting covers both planes without double counting.
    """

    replica_id: int
    scheduler: Scheduler
    plane: DataPlane

    @classmethod
    def from_engine(cls, engine: Any, replica_id: int) -> "Replica":
        """Bind a single-replica :class:`~repro_torch.serve.engine.Engine` as
        one replica of a router (its Scheduler/Executor pair is already
        wired and counter-shared)."""
        engine.scheduler.state.replica_id = replica_id
        return cls(replica_id=replica_id, scheduler=engine.scheduler,
                   plane=engine.executor)

    @property
    def has_prefix(self) -> bool:
        """True when this replica holds a resident shared prefix a fork
        could COW from."""
        s = self.scheduler
        return s.prefix_len > 0 and s.vmem.has_seq(s.PREFIX_ID)

    def load_pages(self) -> int:
        """Placement load metric: frames committed in the pool plus the
        page demand of requests already placed but still queued here.
        The backlog term is what spreads a burst submitted before any
        step runs — committed frames alone are all-zero then."""
        s = self.scheduler
        return s.vmem.pool.num_used + sum(
            s.required_pages(r) for r in s.queue
        )

    def page_report(self) -> dict[str, int]:
        pool = self.scheduler.vmem.pool
        return {"frames": pool.num_pages, "free": pool.num_free,
                "used": pool.num_used, "faults": pool.fault_count}


class ReplicaRouter:
    """Places requests from a global admission queue over N replicas and
    drives every busy replica one :meth:`Scheduler.step_plane` per router
    step.  With one replica and the default unbounded backlog this is
    call-for-call the single-replica ``Engine`` loop."""

    POLICIES = ("least_loaded", "round_robin")

    def __init__(self, replicas: list[Replica],
                 policy: str = "least_loaded",
                 counters: PerfCounters | None = None,
                 max_backlog: int | None = None,
                 migrate: bool = True, migrate_after: int = 8):
        """``max_backlog``: per-replica queued-request bound; placement
        defers (requests wait in the global queue, counted as
        ``cross_replica_queue_waits``) while every eligible replica is at
        the bound AND at least one replica is still busy.  ``None``
        (default) places immediately — required for exact N=1
        equivalence with the plain engine.

        ``migrate``: cross-replica swap migration + reach-aware placement
        (see the module docstring); inert at N=1, so the default ``True``
        preserves exact single-replica equivalence.  ``migrate_after``:
        router steps a swap-FIFO head may sit capacity-blocked before a
        starvation migration is attempted (rescue migrations — victims
        the source is about to fail — never wait)."""
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        ids = [rep.replica_id for rep in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        if policy not in self.POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"choose from {self.POLICIES}")
        if migrate_after < 1:
            raise ValueError(f"migrate_after must be >= 1, "
                             f"got {migrate_after}")
        self.replicas = list(replicas)
        self.policy = policy
        self.counters = counters or PerfCounters()
        self.max_backlog = max_backlog
        self.migrate = migrate
        self.migrate_after = migrate_after
        self.queue: deque[Request] = deque()   # global admission queue
        self.step_i = 0                        # router engine-steps
        self._rr_next = 0
        self._next_req_id = 0
        #: router steps each swap-FIFO HEAD victim has sat capacity-
        #: blocked (the starvation clock); entries are pruned the moment
        #: the victim stops being a blocked head anywhere
        self._swap_age: dict[int, int] = {}

    # ------------------------------------------------------------------
    # queue API
    # ------------------------------------------------------------------

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(
            rep.scheduler.has_work for rep in self.replicas
        )

    @property
    def done(self) -> dict[int, Request]:
        """Merged done map (per-replica completion order preserved within
        each replica; cross-replica order is replica-major)."""
        merged: dict[int, Request] = {}
        for rep in self.replicas:
            merged.update(rep.scheduler.done)
        return merged

    def submit(self, req: ServeRequest) -> int:
        """Enqueue a :class:`~repro_torch.serve.api.ServeRequest` — the one
        public client type (anything else is a ``TypeError``; scheduler-
        plane harnesses submit internal ``Request`` objects through
        ``Scheduler.submit``).  Returns the request id."""
        internal = _lower(
            req, self._alloc_req_id, self.replicas[0].scheduler.cfg
        )
        self._next_req_id = max(self._next_req_id, internal.req_id + 1)
        # TTFT clock starts at ROUTER entry: global-queue wait (backlog
        # bound) must show up in the SLO numbers, so the stamp cannot wait
        # for replica placement (Scheduler.submit only stamps if unset)
        if internal.t_enqueue == 0.0:
            internal.t_enqueue = time.perf_counter()
        self.counters.inc("submitted")
        self.queue.append(internal)
        self._place_pending()
        return internal.req_id

    def _alloc_req_id(self) -> int:
        rid = self._next_req_id
        self._next_req_id += 1
        return rid

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------

    def _eligible(self, req: Request) -> tuple[list[Replica], bool]:
        """Replicas that can legally host ``req``; second element flags
        the fork-affinity constraint (COW pages cannot cross pools)."""
        if req.share_prefix:
            elig = [rep for rep in self.replicas if rep.has_prefix]
            if not elig:
                raise ValueError(
                    f"request {req.req_id} wants share_prefix but no "
                    "replica holds a resident prefix (preload one first)"
                )
            return elig, len(elig) < len(self.replicas)
        return list(self.replicas), False

    def _match_pages(self, rep: Replica, req: Request | None) -> int:
        """Whole pages of ``req``'s prompt resident in ``rep``'s radix
        cache (0 with no request / no cache / no match — every pre-prefix
        ranking reduces to the base policy then)."""
        if req is None:
            return 0
        matched, _ = rep.scheduler.probe_prefix(req)
        return matched // rep.scheduler.cfg.page_size

    def _rank(self, candidates: list[Replica], advance_rr: bool = False,
              req: Request | None = None) -> Replica:
        """Policy choice among ``candidates`` (never empty): the base
        policy plus the additive prefix score for ``req`` (see the module
        docstring).  ``req=None`` ranks prefix-blind — used to attribute
        ``prefix_routed``/``migrations_declined`` to the constraint that
        actually changed the outcome."""
        if self.policy == "round_robin":
            pool = candidates
            best = max((self._match_pages(rep, req) for rep in candidates),
                       default=0)
            if best > 0:
                pool = [rep for rep in candidates
                        if self._match_pages(rep, req) == best]
            n = len(self.replicas)
            for k in range(n):
                cand = self.replicas[(self._rr_next + k) % n]
                if cand in pool:
                    if advance_rr:
                        self._rr_next = (
                            self.replicas.index(cand) + 1
                        ) % n
                    return cand
            raise AssertionError("unreachable: candidates is non-empty")
        return min(candidates,
                   key=lambda rep: (
                       rep.load_pages() - self._match_pages(rep, req),
                       rep.replica_id,
                   ))

    def _backlog_open(self, reps: list[Replica]) -> list[Replica]:
        if self.max_backlog is None:
            return list(reps)
        return [rep for rep in reps
                if len(rep.scheduler.queue) < self.max_backlog]

    def _can_ever_host(self, rep: Replica, req: Request) -> bool:
        """Whether ``rep``'s attainable pool could EVER run ``req`` mapped
        to completion — the scheduler's own admission reach check, asked
        at placement time so a reach-blind policy stops feeding requests
        to replicas that must fail them."""
        s = rep.scheduler
        matched, owner = s.probe_prefix(req)
        return not s._admission_unreachable(req, matched, owner)

    def _place_one(self, req: Request) -> Replica | None:
        """Choose a replica for ``req`` and commit it there, or return
        ``None`` to keep it waiting in the global queue (backlog bound)."""
        elig, constrained = self._eligible(req)
        if self.migrate and len(self.replicas) > 1:
            # reach-aware placement: drop replicas that would fail the
            # request at admission.  If EVERY eligible replica is
            # unreachable the filter is a no-op — the request then fails
            # at admission, which is the correct global verdict.
            reach = [rep for rep in elig if self._can_ever_host(rep, req)]
            if reach and len(reach) < len(elig):
                elig = reach
                self.counters.inc("reach_redirects")
        open_elig = self._backlog_open(elig)
        if not open_elig:
            if any(rep.scheduler.has_work for rep in self.replicas):
                return None              # wait; retried next router step
            open_elig = elig             # idle fleet: never park forever
        if constrained:
            # what the base policy would do with fork affinity ignored,
            # under the SAME backlog conditions (else a backlog-diverted
            # placement would masquerade as a declined migration).
            # Read-only rank: the round-robin pointer does not advance.
            # Forks rank prefix-blind (affinity already restricted the
            # pool to prefix holders — the score would be a no-op).
            free_pool = self._backlog_open(self.replicas) or open_elig
            free_choice = self._rank(free_pool)
            choice = self._rank(open_elig, advance_rr=True)
            if free_choice.replica_id != choice.replica_id:
                self.counters.inc("migrations_declined")
        else:
            # read-only prefix-blind rank first: a placement the prefix
            # score diverted from the base choice counts as prefix_routed
            blind_choice = self._rank(open_elig)
            choice = self._rank(open_elig, advance_rr=True, req=req)
            if blind_choice.replica_id != choice.replica_id:
                self.counters.inc("prefix_routed")
        choice.scheduler.submit(req)     # stamps arrival in replica time
        choice.scheduler.counters.inc("router_placements")
        self.counters.inc("placements")
        self.counters.inc(f"placements_replica{choice.replica_id}")
        self.counters.snapshot("place", (req.req_id, choice.replica_id))
        return choice

    def _place_pending(self) -> None:
        while self.queue:
            if self._place_one(self.queue[0]) is None:
                break
            self.queue.popleft()

    # ------------------------------------------------------------------
    # cross-replica swap migration
    # ------------------------------------------------------------------

    def _resolve_dest_claim(self, rep: Replica, k: int) -> int:
        """Pinned-prefix pages of ``rep`` a migrated victim with a
        ``k``-page source claim could re-share (the fleet invariant:
        preloaded prefixes are identical, so the destination's first
        ``k`` whole prefix pages hold the same bytes)."""
        d = rep.scheduler
        if k and d.vmem.has_seq(d.PREFIX_ID) and \
                k <= min(len(d.vmem.seq(d.PREFIX_ID).pages),
                         d.prefix_len // d.cfg.page_size):
            return k
        return 0

    def _pick_migration_dest(self, src: Replica, req_id: int,
                             immediate: bool) -> Replica | None:
        """Best destination for ``src``'s swapped victim ``req_id``, or
        ``None``.  The pinned-prefix claim is re-resolved per candidate
        (fork affinity as a *preference*: prefix holders see a smaller
        demand, but the record is self-contained so any replica whose
        attainable pool fits is legal).  ``immediate``: require capacity
        to restore right now (starvation moves), not merely reachability
        (rescue moves — the destination may still need to drain/preempt)."""
        s = src.scheduler
        num_tokens = s._spilled_tokens[req_id]
        k = len(s._restorable_shared(req_id))
        pf = s.vmem.config.pages_for
        best: tuple[tuple[int, int], Replica] | None = None
        for rep in self.replicas:
            if rep is src:
                continue
            d = rep.scheduler
            need = pf(num_tokens) - self._resolve_dest_claim(rep, k)
            if need > d.attainable_pages():
                continue
            if immediate and (need > d.vmem.pool.num_free
                              or d.vmem.num_free_slots <= 0
                              or len(d.running) >= d.cfg.max_batch):
                continue
            key = (-d.vmem.pool.num_free, d.replica_id)
            if best is None or key < best[0]:
                best = (key, rep)
        return None if best is None else best[1]

    def _migrate_starved(self) -> None:
        """Once per router step, BEFORE the replicas run: sweep each
        replica's swap-FIFO head and migrate victims the source is about
        to fail (rescue) or has starved past ``migrate_after`` blocked
        steps (starvation).  Head-only, so per-replica swap-FIFO
        completion order is never reordered by migration."""
        live: set[int] = set()
        for src in self.replicas:
            s = src.scheduler
            if not s.swapped:
                continue
            rid = s.swapped[0]
            shared = s._restorable_shared(rid)
            need = (s.vmem.config.pages_for(s._spilled_tokens[rid])
                    - len(shared))
            rescue = need > s.attainable_pages()
            if not rescue and s.can_restore(rid):
                continue                  # restores at the source this step
            live.add(rid)
            age = self._swap_age.get(rid, 0) + 1
            self._swap_age[rid] = age
            if not rescue and age < self.migrate_after:
                continue
            dest = self._pick_migration_dest(src, rid, immediate=not rescue)
            if dest is None:
                continue                  # no host anywhere: verdict stands
            exp = s.export_swapped(rid)
            try:
                dest.scheduler.import_swapped(exp)
            except Exception:
                # destination plane rejected the record (raised before any
                # side effect, per the DataPlane contract): roll back at
                # the source HEAD so FIFO order is unchanged
                self.counters.inc("migration_aborts")
                s.import_swapped(exp, front=True)
                continue
            live.discard(rid)
            self.counters.inc("restore_migrations")
            self.counters.snapshot(
                "migrate", (rid, src.replica_id, dest.replica_id))
        # prune starvation clocks for victims that restored, retired,
        # migrated or stopped being a blocked head
        for rid in list(self._swap_age):
            if rid not in live:
                del self._swap_age[rid]

    # ------------------------------------------------------------------
    # drive
    # ------------------------------------------------------------------

    def step(self) -> None:
        self.step_i += 1
        if self.migrate and len(self.replicas) > 1:
            self._migrate_starved()
        self._place_pending()
        if self.queue:
            # request-steps spent waiting in the global queue (every
            # eligible replica at its backlog bound)
            self.counters.inc("cross_replica_queue_waits", len(self.queue))
        for rep in self.replicas:
            if rep.scheduler.has_work:
                rep.scheduler.step_plane()
        # retirements may have opened slots/frames for deferred placements
        self._place_pending()

    def run(self, max_steps: int = 10_000) -> dict[int, Request]:
        """Drive until every placed and pending request completes, or the
        slowest still-busy replica's token-step clock reaches
        ``max_steps`` (the same per-replica budget semantics as
        ``Engine.run``: fused horizons advance a replica's clock in
        token-steps)."""
        while self.has_work and self._clock() < max_steps:
            self.step()
        return self.done

    def drain(self, max_steps: int = 10_000) -> dict[int, ServeResult]:
        """Drive to completion, flush every replica's async stream sink
        (re-raising the first callback exception), and return typed
        :class:`~repro_torch.serve.api.ServeResult` records by request id."""
        self.run(max_steps)
        for rep in self.replicas:
            stream = rep.scheduler.stream
            if stream is not None:
                stream.drain()
        return {
            rid: ServeResult.from_request(r)
            for rid, r in self.done.items()
        }

    def _clock(self) -> int:
        active = [rep.scheduler.step_i for rep in self.replicas
                  if rep.scheduler.has_work]
        if active:
            return min(active)
        return min(rep.scheduler.step_i for rep in self.replicas)

    # ------------------------------------------------------------------
    # accounting / invariants
    # ------------------------------------------------------------------

    def global_counters(self) -> collections.Counter:
        """Router counters + the sum of every replica's counters.  The
        cross-replica invariant the test suite asserts: each merged total
        equals the sum of the per-replica values."""
        merged = PerfCounters.merged(
            rep.scheduler.counters for rep in self.replicas
        )
        merged.update(self.counters.counters)
        return merged

    def global_page_report(self) -> dict[str, int]:
        """Fleet-wide page accounting — by construction the element-wise
        sum of the per-replica reports (asserted in
        :meth:`check_invariants`)."""
        total = collections.Counter()
        for rep in self.replicas:
            total.update(rep.page_report())
        return dict(total)

    def check_invariants(self) -> None:
        """Cross-replica conservation, checked from INDEPENDENT sources
        (``global_page_report``/``global_counters`` are definitionally
        per-replica sums, so comparing them against a re-computed sum
        would be a tautology):

        * every replica's vmem/pool is internally consistent and its
          frame arithmetic closes (used + free == configured frames);
        * request conservation: the router-side ``submitted`` counter
          equals the number of request OBJECTS tracked across the global
          queue and every replica's queued/running/swapped/done;
        * placement accounting across planes: the router-incremented
          ``placements``/``placements_replica{i}`` counters agree with
          each other AND with the replica-side ``router_placements``
          counters (incremented on the replica's own counter object);
        * completion accounting: replica-summed ``completed`` /
          ``failed_unreachable`` counters equal the done/failed statuses
          carried by the merged ``done`` requests themselves.
        """
        for rep in self.replicas:
            rep.scheduler.vmem.check_invariants()
            pool = rep.scheduler.vmem.pool
            if pool.num_used + pool.num_free != pool.num_pages:
                raise AssertionError(
                    f"replica {rep.replica_id} frame arithmetic broken: "
                    f"{pool.num_used} used + {pool.num_free} free != "
                    f"{pool.num_pages} frames"
                )
        tracked = len(self.queue) + sum(
            rep.scheduler.state.num_tracked for rep in self.replicas
        )
        submitted = self.counters.get("submitted")
        if tracked != submitted:
            raise AssertionError(
                f"request conservation broken: {submitted} submitted but "
                f"{tracked} tracked across queue + replicas"
            )
        placed = sum(
            self.counters.get(f"placements_replica{rep.replica_id}")
            for rep in self.replicas
        )
        replica_side = sum(
            rep.scheduler.counters.get("router_placements")
            for rep in self.replicas
        )
        if not (placed == replica_side == self.counters.get("placements")):
            raise AssertionError(
                "placement accounting broken: per-replica counters "
                f"{placed}, replica-side records {replica_side}, global "
                f"{self.counters.get('placements')} disagree"
            )
        done = self.done
        by_status = collections.Counter(r.status for r in done.values())
        counted = PerfCounters.merged(
            rep.scheduler.counters for rep in self.replicas
        )
        if counted["completed"] != by_status["done"] or \
                counted["failed_unreachable"] != by_status["failed"]:
            raise AssertionError(
                f"completion accounting broken: counters say "
                f"{counted['completed']} done / "
                f"{counted['failed_unreachable']} failed, request objects "
                f"say {by_status['done']} / {by_status['failed']}"
            )

    def stats(self) -> dict[str, Any]:
        return {
            "router": self.counters.report(),
            "global_counters": dict(self.global_counters()),
            "global_pages": self.global_page_report(),
            "replicas": {
                rep.replica_id: {
                    "counters": dict(rep.scheduler.counters.counters),
                    "pages": rep.page_report(),
                    "step_i": rep.scheduler.step_i,
                }
                for rep in self.replicas
            },
        }

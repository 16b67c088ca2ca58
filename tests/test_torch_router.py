"""The multi-replica serve path: the port's router against the JAX router.

Every scenario of ``tests/test_serve_router.py`` and
``tests/test_swap_migration.py`` runs twice on the same inputs: through
``repro.serve`` (the JAX router over the fault planes of
``tests/_fault_plane.py``, or JAX engines on their ``use_kernels=False``
paths) and through ``repro_torch.serve`` (the port's router over the same
fault planes bound to the port, ``tests/_torch_fault_plane.py``, or port
engines on the CPU, where the kernel wrappers take their plain versions).
Each run keeps the JAX test's own assertions, and the two runs must agree
exactly in outputs, statuses, completion order, router counters,
per-replica counters, ``place``/``migrate`` snapshots and the fault
planes' call sequences.  The randomized sweeps run under fixed seeds.
The real-engine rescue also holds the exported swap record (``page_data``)
equal to JAX's bit for bit, native f32 and int8.
"""

import collections
import copy
import types

import jax
import numpy as np
import pytest
import torch

import _fault_plane
import _torch_fault_plane
import repro.serve
import repro_torch.serve
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_jax

pytestmark = [pytest.mark.torch_port, pytest.mark.router]

JAX = types.SimpleNamespace(name="jax", serve=repro.serve, fp=_fault_plane)
PORT = types.SimpleNamespace(name="port", serve=repro_torch.serve,
                             fp=_torch_fault_plane)


# ---------------------------------------------------------------------------
# helpers (one package's surface at a time: ``ns`` is JAX or PORT)
# ---------------------------------------------------------------------------


def plain(x):
    """Numpy scalars and arrays as Python values, containers recursively,
    so two packages' summaries compare with ``==``."""
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(plain(v) for v in x)
    if isinstance(x, (list, collections.deque)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def req(ns, i, plen=6, max_new=8, **kw):
    return ns.serve.ServeRequest(
        req_id=i, prompt=np.arange(plen, dtype=np.int32),
        max_new_tokens=max_new, **kw)


def make_router(ns, n, policy="least_loaded", schedules=None,
                max_backlog=None, per_replica=None, migrate=True,
                migrate_after=8, **kw):
    """N fault-plane replicas behind one router (the two JAX suites'
    ``make_router`` in one: heterogeneous pools via ``per_replica``)."""
    replicas, planes = [], []
    for r in range(n):
        rkw = dict(kw)
        rkw.update((per_replica or {}).get(r, {}))
        sched, plane = ns.fp.make_replica(
            replica_id=r, schedule=(schedules or {}).get(r, ()), **rkw)
        replicas.append(ns.serve.Replica(replica_id=r, scheduler=sched,
                                         plane=plane))
        planes.append(plane)
    return ns.serve.ReplicaRouter(
        replicas, policy=policy, max_backlog=max_backlog, migrate=migrate,
        migrate_after=migrate_after), planes


def outputs(done):
    return {rid: [int(x) for x in r.output] for rid, r in done.items()}


def statuses(done):
    return sorted((rid, r.status) for rid, r in done.items())


def closed_form(ns, reqs):
    return {r.req_id: ns.fp.expected_output(r) for r in reqs}


def summary(router, planes=()):
    """Everything the parity check compares for one router run."""
    done = router.done
    return plain(dict(
        outputs=outputs(done),
        order=[(rid, r.status) for rid, r in done.items()],
        router=dict(router.counters.counters),
        replicas=[dict(rep.scheduler.counters.counters)
                  for rep in router.replicas],
        clocks=[rep.scheduler.step_i for rep in router.replicas],
        pages=router.global_page_report(),
        snapshots={k: [s.payload for s in router.counters.events(k)]
                   for k in ("place", "migrate")},
        events=[p.events for p in planes],
        queued=len(router.queue),
    ))


def assert_accounting(router):
    """The JAX suites' cross-replica checks: invariants, and merged
    counters and pages equal to the per-replica sums recomputed by hand."""
    router.check_invariants()
    manual = collections.Counter()
    for rep in router.replicas:
        manual.update(rep.scheduler.counters.counters)
    manual.update(router.counters.counters)
    assert router.global_counters() == manual
    pages = collections.Counter()
    for rep in router.replicas:
        pages.update(rep.page_report())
    assert router.global_page_report() == dict(pages)


def assert_no_swap_records(planes):
    for i, plane in enumerate(planes):
        assert plane.swapped_out == [], f"plane {i} leaked swap records"


def preload_fake_prefix(replica, plen):
    """Resident shared prefix on a fake replica: host bookkeeping only."""
    s = replica.scheduler
    s.vmem.map_seq(s.PREFIX_ID, plen)
    s.prefix_len = plen


def both(scenario, *args):
    """Run ``scenario`` through the JAX package and the port; the port's
    summary must equal JAX's."""
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# the fault-injected sweeps (tests/test_serve_router.py and, with
# migration-heavy schedules, tests/test_swap_migration.py)
# ---------------------------------------------------------------------------

USABLE_PAGES = 8


def gen_workload(rng):
    n = int(rng.integers(2, 9))
    return [(i, int(rng.integers(1, 13)), int(rng.integers(1, 11)))
            for i in range(n)]


def gen_faults(rng, rids, migration, steps_hi=30):
    """The JAX suites' schedules: spills, hogs, restore failures, delayed
    completions, and with ``migration`` spills chased by pool-hogging
    windows and rejected imports."""
    kinds = ["hog", "force_spill", "fail_restore", "delay_done"]
    if migration:
        kinds += ["starve", "reject_import"]
    events = []
    for _ in range(int(rng.integers(0, 5))):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        step = int(rng.integers(1, steps_hi))
        rid = int(rng.choice(rids))
        if kind == "hog":
            events.append(("hog", step, int(rng.integers(1, 4)),
                           int(rng.integers(1, 7))))
        elif kind == "force_spill":
            events.append(("force_spill", step, rid))
        elif kind in ("fail_restore", "delay_done"):
            events.append((kind, step, rid, int(rng.integers(1, 4))))
        elif kind == "starve":
            events.append(("force_spill", step, rid))
            events.append(("hog", step, USABLE_PAGES * 2,
                           int(rng.integers(4, 16))))
        else:
            events.append(("reject_import", step, rid,
                           int(rng.integers(1, 3))))
    return tuple(events)


def sweep(ns, seed, migration):
    rng = np.random.default_rng(seed)
    spec = gen_workload(rng)
    reqs = [req(ns, i, plen, max_new) for i, plen, max_new in spec]
    ref, ref_planes = make_router(ns, 1, usable_pages=USABLE_PAGES)
    for r in reqs:
        ref.submit(copy.deepcopy(r))
    assert ns.fp.drive_router(ref, ref_planes) < 500
    ref_done = dict(ref.done)
    assert outputs(ref_done) == closed_form(ns, reqs)
    assert all(r.status == "done" for r in ref_done.values())
    runs = {"ref": summary(ref, ref_planes)}
    for n in (1, 2, 4):
        schedules = {i: gen_faults(rng, [r[0] for r in spec], migration)
                     for i in range(n)}
        router, planes = make_router(
            ns, n, schedules=schedules, usable_pages=USABLE_PAGES,
            migrate_after=2 if migration else 8)
        for r in reqs:
            router.submit(copy.deepcopy(r))
        assert ns.fp.drive_router(router, planes) < 500, f"N={n} starved"
        done = router.done
        assert outputs(done) == outputs(ref_done), f"N={n} diverged"
        assert statuses(done) == statuses(ref_done)
        assert_accounting(router)
        total = router.global_counters()
        assert total["decode_tokens"] == sum(max(2, m) - 1
                                             for _, _, m in spec)
        assert total["completed"] == total["placements"] == len(reqs)
        assert total["swap_exports"] == (total["restore_migrations"]
                                         + total["migration_aborts"])
        assert total["swap_imports"] == total["swap_exports"]
        assert total["failed_unreachable"] == 0
        assert_no_swap_records(planes)
        runs[n] = summary(router, planes)
    return runs


SEEDS = (0, 4, 7, 13, 26, 50)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("migration", [False, True],
                         ids=["faults", "migration"])
def test_fault_injected_sweep_matches_jax(seed, migration):
    """N in {1, 2, 4} under random fault schedules: token identity with
    the fault-free N=1 reference and exact accounting in both packages,
    and the port's every run equal to JAX's."""
    both(sweep, seed, migration)


def test_sweeps_exercise_migration_and_faults():
    """The fixed seeds are not vacuous: across them the port's migrating
    sweeps moved victims, aborted an import and restored after injected
    failures."""
    total = collections.Counter()
    for seed in SEEDS:
        runs = sweep(PORT, seed, True)
        for n in (2, 4):
            total.update(runs[n]["router"])
            for c in runs[n]["replicas"]:
                total.update(c)
    assert total["restore_migrations"] > 0
    assert total["migration_aborts"] > 0
    assert total["restore_failures"] > 0
    assert total["preemptions"] > 0


# ---------------------------------------------------------------------------
# counter invariants
# ---------------------------------------------------------------------------

WATCHED = ("host_syncs", "ptab_syncs", "ptab_rows_uploaded",
           "decode_horizon", "decode_tokens", "decode_dispatches",
           "preemptions", "restores", "restore_failures", "page_faults",
           "submitted", "completed")


def monotone_counters(ns):
    sched, plane = ns.fp.make_replica(
        usable_pages=6, max_batch=2,
        schedule=(("force_spill", 4, 0), ("fail_restore", 5, 0, 2),
                  ("hog", 8, 2, 3)))
    for i in range(4):
        sched.submit(ns.serve.to_internal(req(ns, i, plen=6, max_new=8)))
    trail, last, steps = [], dict.fromkeys(WATCHED, 0), 0
    while sched.has_work and steps < 300:
        steps += 1
        plane.tick(steps)
        sched.step_plane()
        now = {k: sched.counters.get(k) for k in WATCHED}
        assert all(now[k] >= last[k] for k in WATCHED)
        trail.append(now)
        last = now
    assert steps < 300 and not sched.has_work
    assert last["restore_failures"] == 2 and last["completed"] == 4
    assert last["preemptions"] >= 1 and last["restores"] >= 1
    sched.vmem.check_invariants()
    return plain(dict(trail=trail, events=plane.events,
                      outputs=outputs(sched.done)))


def totals_across_preempt_fork_restore(ns):
    router, planes = make_router(
        ns, 2, usable_pages=6, max_batch=2,
        schedules={0: (("force_spill", 6, 0),), 1: (("force_spill", 7, 1),)})
    for rep in router.replicas:
        preload_fake_prefix(rep, plen=6)
    reqs = [req(ns, i, plen=4, max_new=8, share_prefix=(i % 2 == 0))
            for i in range(6)]
    for r in reqs:
        router.submit(copy.deepcopy(r))
    assert ns.fp.drive_router(router, planes) < 500
    total = router.global_counters()
    for name in set(total) | set(WATCHED):
        parts = sum(rep.scheduler.counters.get(name)
                    for rep in router.replicas)
        assert total[name] == parts + router.counters.get(name), name
    assert total["forked_admissions"] > 0
    assert total["preemptions"] >= 2 and total["restores"] >= 1
    for rep in router.replicas:
        assert rep.scheduler.counters.get("decode_tokens") > 0
    assert outputs(router.done) == closed_form(ns, reqs)
    router.check_invariants()
    return summary(router, planes)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def round_robin(ns):
    router, planes = make_router(ns, 3, policy="round_robin")
    for i in range(6):
        router.submit(req(ns, i))
    assert [p.payload[1] for p in router.counters.events("place")] == \
        [0, 1, 2, 0, 1, 2]
    assert ns.fp.drive_router(router, planes) < 500
    router.check_invariants()
    return summary(router, planes)


def least_loaded_burst(ns):
    router, planes = make_router(ns, 2)
    for i in range(4):
        router.submit(req(ns, i, plen=6))
    assert [p.payload[1] for p in router.counters.events("place")] == \
        [0, 1, 0, 1]
    assert ns.fp.drive_router(router, planes) < 500
    router.check_invariants()
    return summary(router, planes)


def fork_affinity(ns):
    router, planes = make_router(ns, 2)
    preload_fake_prefix(router.replicas[1], plen=6)
    router.submit(req(ns, 0, plen=4, share_prefix=True))
    router.submit(req(ns, 1, plen=4, share_prefix=True))
    assert [p.payload[1] for p in router.counters.events("place")] == [1, 1]
    assert router.counters.get("migrations_declined") == 2
    router.submit(req(ns, 2, plen=4))
    assert router.counters.events("place")[-1].payload[1] == 0
    assert ns.fp.drive_router(router, planes) < 500
    assert statuses(router.done) == [(0, "done"), (1, "done"), (2, "done")]
    router.check_invariants()
    return summary(router, planes)


def backlog_diverted_fork(ns):
    router, planes = make_router(ns, 3, max_backlog=1)
    preload_fake_prefix(router.replicas[0], plen=6)
    preload_fake_prefix(router.replicas[1], plen=6)
    router.replicas[0].scheduler.submit(
        ns.serve.to_internal(req(ns, 90, plen=2)))
    router.submit(req(ns, 0, plen=4, share_prefix=True))
    assert router.counters.events("place")[-1].payload[1] == 1
    assert router.counters.get("migrations_declined") == 1
    router.submit(req(ns, 1, plen=4))
    assert router.counters.events("place")[-1].payload[1] == 2
    assert router.counters.get("migrations_declined") == 1
    return summary(router, planes)


def prefix_aware_ranking(ns):
    """A plain request whose prompt starts with replica 1's resident
    prefix goes there against the base policy's choice and counts
    ``prefix_routed``.  Least-loaded: a 1-page filler on replica 0 still
    beats the prefix's 2 pages blind, not once the 2 matched pages are
    subtracted.  Round-robin: the cycle points at replica 0."""
    out = {}
    for policy in ("least_loaded", "round_robin"):
        router, planes = make_router(ns, 2, policy=policy, usable_pages=15)
        s1 = router.replicas[1].scheduler
        base = np.arange(100, 108, dtype=np.int32)
        s1.vmem.map_seq(s1.PREFIX_ID, len(base))
        s1.prefix_len = len(base)
        s1.register_resident(s1.PREFIX_ID, base)
        hit = ns.serve.ServeRequest(
            req_id=0, max_new_tokens=4,
            prompt=np.concatenate([base, np.arange(3, dtype=np.int32)]))
        filler = req(ns, 1, plen=2, max_new=4)
        order = (filler, hit) if policy == "least_loaded" else (hit, filler)
        for r in order:
            router.submit(r)
        assert {p.payload for p in router.counters.events("place")} == \
            {(0, 1), (1, 0)}
        assert router.counters.get("prefix_routed") == 1
        assert ns.fp.drive_router(router, planes) < 500
        assert router.global_counters()["prefix_hits"] == 1
        router.check_invariants()
        out[policy] = summary(router, planes)
    return out


def bounded_backlog(ns):
    router, planes = make_router(ns, 2, max_backlog=1, max_batch=1,
                                 usable_pages=4)
    reqs = [req(ns, i, plen=4, max_new=6) for i in range(5)]
    for r in reqs:
        router.submit(copy.deepcopy(r))
    assert router.counters.get("placements") == 2 and len(router.queue) == 3
    assert ns.fp.drive_router(router, planes) < 500
    assert router.counters.get("cross_replica_queue_waits") > 0
    assert router.counters.get("placements") == 5
    assert outputs(router.done) == closed_form(ns, reqs)
    router.check_invariants()
    return summary(router, planes)


def refusals(ns):
    """Bad fleets and an unplaceable fork raise ValueError, in the same
    words."""
    msgs = []
    router, _ = make_router(ns, 2)
    with pytest.raises(ValueError, match="share_prefix") as e:
        router.submit(req(ns, 0, share_prefix=True))
    msgs.append(str(e.value))
    with pytest.raises(ValueError, match="at least one") as e:
        ns.serve.ReplicaRouter([])
    msgs.append(str(e.value))
    sched, plane = ns.fp.make_replica()
    rep = ns.serve.Replica(replica_id=0, scheduler=sched, plane=plane)
    for kw, match in ((dict(replicas=[rep, rep]), "duplicate"),
                      (dict(replicas=[rep], policy="hottest_replica"),
                       "policy"),
                      (dict(replicas=[rep], migrate_after=0),
                       "migrate_after")):
        with pytest.raises(ValueError, match=match) as e:
            ns.serve.ReplicaRouter(**kw)
        msgs.append(str(e.value))
    with pytest.raises(TypeError, match="ServeRequest"):
        router.submit(ns.serve.to_internal(req(ns, 5)))
    return msgs


# ---------------------------------------------------------------------------
# N=1 equivalence and the run budget
# ---------------------------------------------------------------------------


def n1_equivalence(ns):
    reqs = [req(ns, i, plen=5 + i, max_new=6) for i in range(4)]
    sched, plane = ns.fp.make_replica(usable_pages=8, max_batch=2)
    for r in reqs:
        sched.submit(ns.serve.to_internal(copy.deepcopy(r)))
    ns.fp.drive(sched, plane)
    router, planes = make_router(ns, 1, usable_pages=8, max_batch=2)
    for r in reqs:
        router.submit(copy.deepcopy(r))
    ns.fp.drive_router(router, planes)
    rsched = router.replicas[0].scheduler
    assert outputs(sched.done) == outputs(router.done)
    assert list(sched.done) == list(router.done)
    assert sched.step_i == rsched.step_i
    b = dict(rsched.counters.counters)
    b.pop("router_placements")
    assert dict(sched.counters.counters) == b
    assert plane.events == planes[0].events
    return summary(router, planes)


def run_budget(ns, max_horizon):
    def fresh():
        sched, plane = ns.fp.make_replica(max_horizon=max_horizon)
        sched.submit(ns.serve.to_internal(req(ns, 0, plen=6, max_new=5)))
        return sched, plane
    sched, plane = fresh()
    clocks = [0]
    while sched.has_work and sched.step_i < 100:
        plane.tick(len(clocks))
        sched.step_plane()
        clocks.append(sched.step_i)
    final, before_final = clocks[-1], clocks[-2]
    sched, _ = fresh()
    while sched.has_work and sched.step_i < before_final + 1:
        sched.step_plane()
    assert sched.done[0].status == "done" and len(sched.done[0].output) == 5
    assert sched.step_i == final
    sched2, _ = fresh()
    while sched2.has_work and sched2.step_i < before_final:
        sched2.step_plane()
    assert 0 not in sched2.done and sched2.has_work
    return clocks


def router_run_budget(ns):
    reqs = [req(ns, i, plen=6, max_new=5) for i in range(3)]
    probe, _ = make_router(ns, 2)
    for r in reqs:
        probe.submit(copy.deepcopy(r))
    probe.run(max_steps=10_000)
    final = max(rep.scheduler.step_i for rep in probe.replicas)
    router, _ = make_router(ns, 2)
    for r in reqs:
        router.submit(copy.deepcopy(r))
    done = router.run(max_steps=final)
    assert statuses(done) == statuses(probe.done) and not router.has_work
    short, _ = make_router(ns, 2, max_horizon=1)
    for r in reqs:
        short.submit(copy.deepcopy(r))
    short.run(max_steps=1)
    assert short.has_work
    return [summary(probe), summary(router), summary(short)]


# ---------------------------------------------------------------------------
# swap migration (tests/test_swap_migration.py)
# ---------------------------------------------------------------------------


def starvation(ns, migrate):
    """Replica 0 spills req 0 at step 3 and a hog then holds its whole
    pool for 60 steps; replica 1 idles with room to spare."""
    router, planes = make_router(
        ns, 2, schedules={0: (("force_spill", 3, 0), ("hog", 3, 16, 60))},
        migrate=migrate, migrate_after=2, usable_pages=8, max_batch=2,
        max_horizon=1)
    reqs = [req(ns, 0, plen=6, max_new=10), req(ns, 1, plen=6, max_new=4)]
    for r in reqs:
        router.submit(copy.deepcopy(r))
    assert ns.fp.drive_router(router, planes) < 500
    total = router.global_counters()
    if migrate:
        assert total["restore_migrations"] == 1
        assert total["swap_exports"] == total["swap_imports"] == 1
        assert ("restore", 0) in planes[1].events
        assert ("restore", 0) not in planes[0].events
        assert [s.payload for s in router.counters.events("migrate")] == \
            [(0, 0, 1)]
    else:
        assert total["restore_migrations"] == total["swap_exports"] == 0
        assert ("restore", 0) in planes[0].events
    assert total["failed_unreachable"] == 0
    assert outputs(router.done) == closed_form(ns, reqs)
    assert_no_swap_records(planes)
    router.check_invariants()
    return summary(router, planes)


def stranded(ns, migrate):
    """A victim whose spilled footprint exceeds the small replica's whole
    pool, stranded there scheduler-plane: replica 0 can never restore it,
    replica 1 can."""
    router, planes = make_router(
        ns, 2, migrate=migrate, migrate_after=2, usable_pages=15,
        max_batch=2, max_horizon=1,
        per_replica={0: {"usable_pages": 4, "max_pages": 8}})
    router.submit(req(ns, 9, plen=4, max_new=2))
    r = req(ns, 0, plen=11, max_new=8)
    router.submit(copy.deepcopy(r))
    s0, s1 = (rep.scheduler for rep in router.replicas)
    assert router.counters.get("placements_replica1") == 1
    steps = 0
    while not (0 in s1.running and s1.vmem.config.pages_for(
            s1.vmem.seq_len(0)) > s0.attainable_pages()):
        steps += 1
        assert steps < 100
        for p in planes:
            p.tick(steps)
        router.step()
    s1.spill(s1.running[0])
    s0.import_swapped(s1.export_swapped(0))
    assert ns.fp.drive_router(router, planes) < 500
    total = router.global_counters()
    if migrate:
        assert total["restore_migrations"] == 1
        assert total["failed_unreachable"] == 0
        assert router.done[0].status == "done"
        assert outputs(router.done)[0] == ns.fp.expected_output(r)
    else:
        assert total["restore_migrations"] == 0
        assert total["failed_unreachable"] == 1
        assert router.done[0].status == "failed"
        assert ("discard", 0) in planes[0].events
    assert_no_swap_records(planes)
    router.check_invariants()
    return summary(router, planes)


def reach_redirect(ns):
    router, planes = make_router(
        ns, 2, migrate_after=2, usable_pages=15, max_batch=2, max_horizon=1,
        per_replica={0: {"usable_pages": 4, "max_pages": 8}})
    router.submit(req(ns, 0, plen=11, max_new=8))
    assert router.counters.get("reach_redirects") == 1
    assert router.counters.get("placements_replica1") == 1
    assert ns.fp.drive_router(router, planes) < 500
    assert router.global_counters()["failed_unreachable"] == 0
    router.check_invariants()
    return summary(router, planes)


def migration_fault(ns, dest_schedule):
    """The starvation pair with a fault on the destination: a rejected
    import (rolled back at the source head, counted, retried) or a hog
    right after the import lands (restore blocked there, then done)."""
    router, planes = make_router(
        ns, 2, schedules={0: (("force_spill", 3, 0), ("hog", 3, 16, 60)),
                          1: dest_schedule},
        migrate_after=2, usable_pages=8, max_batch=2, max_horizon=1)
    reqs = [req(ns, 0, plen=6, max_new=10), req(ns, 1, plen=6, max_new=4)]
    for r in reqs:
        router.submit(copy.deepcopy(r))
    assert ns.fp.drive_router(router, planes) < 500
    total = router.global_counters()
    assert total["restore_migrations"] == 1
    assert total["failed_unreachable"] == 0
    if dest_schedule[0][0] == "reject_import":
        assert total["migration_aborts"] == 1
        assert total["swap_exports"] == total["swap_imports"] == 2
        assert ("import_rejected", 0) in planes[1].events
    else:
        assert ("restore", 0) in planes[1].events
    assert outputs(router.done) == closed_form(ns, reqs)
    assert_no_swap_records(planes)
    router.check_invariants()
    return summary(router, planes)


def export_of_retired(ns):
    sched, plane = ns.fp.make_replica(max_horizon=1)
    sched.submit(ns.serve.to_internal(req(ns, 0, plen=6, max_new=4)))
    ns.fp.drive(sched, plane)
    assert sched.done[0].status == "done"
    with pytest.raises(KeyError, match="not swapped") as e:
        sched.export_swapped(0)
    return str(e.value)


def partial_restore(ns, patience):
    sched, plane = ns.fp.make_replica(
        page_size=4, usable_pages=8, max_pages=8, max_batch=2,
        max_horizon=1, restore_patience=patience,
        schedule=(("force_spill", 4, 0), ("hog", 4, 6, 10)))
    r = req(ns, 0, plen=8, max_new=8)
    sched.submit(ns.serve.to_internal(r))
    assert ns.fp.drive(sched, plane, max_steps=300) < 300
    c = sched.counters
    if patience:
        assert c.get("partial_restores") == 1 and c.get("restores") == 0
        assert c.get("pages_refilled") >= 1
        assert any(e[0] == "admit_forked_batch" for e in plane.events)
    else:
        assert c.get("partial_restores") == 0 and c.get("restores") == 1
    assert [int(x) for x in sched.done[0].output] == ns.fp.expected_output(r)
    assert plane.swapped_out == [] and sched.state.partial_resume == {}
    sched.vmem.check_invariants()
    return plain(dict(counters=dict(c.counters), events=plane.events,
                      output=outputs(sched.done)))


SCENARIOS = {
    "monotone_counters": (monotone_counters,),
    "totals_across_preempt_fork_restore":
        (totals_across_preempt_fork_restore,),
    "round_robin": (round_robin,),
    "least_loaded_burst": (least_loaded_burst,),
    "fork_affinity": (fork_affinity,),
    "backlog_diverted_fork": (backlog_diverted_fork,),
    "prefix_aware_ranking": (prefix_aware_ranking,),
    "bounded_backlog": (bounded_backlog,),
    "refusals": (refusals,),
    "n1_equivalence": (n1_equivalence,),
    "run_budget_h1": (run_budget, 1),
    "run_budget_h8": (run_budget, 8),
    "router_run_budget": (router_run_budget,),
    "starvation_migrates": (starvation, True),
    "starvation_waits_without_migration": (starvation, False),
    "rescue_migrates": (stranded, True),
    "rescue_off_fails_unreachable": (stranded, False),
    "reach_redirect": (reach_redirect,),
    "rejected_import_rolls_back": (
        migration_fault, (("reject_import", 1, 0, 1),)),
    "destination_fills_mid_import": (
        migration_fault, (("hog", 6, 16, 12),)),
    "export_of_retired_raises": (export_of_retired,),
    "partial_restore": (partial_restore, 2),
    "partial_restore_off": (partial_restore, 0),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    scenario, *args = SCENARIOS[name]
    both(scenario, *args)


# ---------------------------------------------------------------------------
# real engines: the reduced qwen2-7b, JAX on its use_kernels=False paths,
# the port on the CPU, the same weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("qwen2-7b", reduced=True)
    jm = jax_build_model(jcfg, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_config("qwen2-7b", reduced=True)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return {"jax": (jm, jp), "port": (build_model(cfg, device="cpu"), tp)}


def engine(ns, models, **cfg):
    model, params = models[ns.name]
    return ns.serve.Engine(model, params, ns.serve.ServeConfig(**cfg))


def real_workload(ns, vocab, n, seed, max_new=8):
    rng = np.random.default_rng(seed)
    return [ns.serve.ServeRequest(
        req_id=i, prompt=rng.integers(0, vocab, size=int(rng.integers(5, 12)))
        .astype(np.int32), max_new_tokens=max_new) for i in range(n)]


ROOMY = dict(page_size=4, num_pages=64, max_pages_per_seq=32, max_batch=3)


def engine_summary(out, engines):
    """A real-engine run's summary for the parity check, with each
    replica's ``SwitchStats``.  ``kernel_dispatches`` is the one counter
    set apart: the JAX engines run a ``use_kernels=False`` model, which JAX
    does not tally, while the port's model dispatches its kernel wrappers
    (their plain versions on the CPU).  Neither takes the plain-path
    hatch."""
    for counters in out["replicas"]:
        counters.pop("kernel_dispatches", None)
        assert counters.get("ref_path_dispatches", 0) == 0
    out["switch"] = [vars(e.switcher.stats) for e in engines]
    return out


def real_n2(ns, models):
    """Two engines over one weight set behind the router reproduce the
    single engine's greedy streams; both replicas decode."""
    vocab = models[ns.name][0].cfg.vocab_size
    reqs = real_workload(ns, vocab, n=5, seed=3)
    ref = engine(ns, models, **ROOMY)
    for r in reqs:
        ref.submit(copy.deepcopy(r))
    ref_done = ref.run()
    engines = [engine(ns, models, **ROOMY) for _ in range(2)]
    router = ns.serve.ReplicaRouter(
        [e.as_replica(i) for i, e in enumerate(engines)])
    for r in reqs:
        router.submit(copy.deepcopy(r))
    done = router.run()
    assert outputs(done) == outputs(ref_done)
    assert statuses(done) == statuses(ref_done)
    for i, e in enumerate(engines):
        assert router.counters.get(f"placements_replica{i}") > 0
        assert e.counters.get("decode_tokens") > 0
    assert_accounting(router)
    out = engine_summary(summary(router), engines)
    for e in engines + [ref]:
        e.close()
    return out


def real_leak_audit(ns, models):
    """A tight pool churns spill/restore; at drain the switcher holds no
    swap record."""
    vocab = models[ns.name][0].cfg.vocab_size
    eng = engine(ns, models, page_size=4, num_pages=10, max_pages_per_seq=16,
                 max_batch=3)
    rng = np.random.default_rng(11)
    for i in range(5):
        eng.submit(ns.serve.ServeRequest(
            req_id=i, max_new_tokens=8, prompt=rng.integers(
                0, vocab, size=int(rng.integers(6, 11))).astype(np.int32)))
    done = eng.run()
    assert all(r.status == "done" for r in done.values())
    assert eng.counters.get("preemptions") > 0
    assert eng.switcher.swapped_out == []
    eng.vmem.check_invariants()
    eng.close()
    return engine_summary(plain(dict(
        outputs=outputs(done), replicas=[dict(eng.counters.counters)])),
        [eng])


def real_rescue(ns, models, kv_dtype, seed_kv=None):
    """A spilled victim stranded on a small-pool replica is rescued to the
    roomy one: its exported host KV pages re-enter the destination's pool
    and greedy decode continues as the untouched single engine's does.

    Returns the summary, the exported record's ``page_data`` and the
    victim's frames with their K/V bytes just before the spill.  With
    ``seed_kv`` (those of a JAX run) the victim's own bytes must equal
    them — exactly over int8 pools, within 1e-5 in f32, where XLA and
    torch sum the projections in another order — and are then overwritten
    with them, so the record compared bit for bit holds the same bytes."""
    vocab = models[ns.name][0].cfg.vocab_size
    big = dict(ROOMY, max_horizon=1, kv_dtype=kv_dtype)
    small = dict(big, num_pages=8, max_pages_per_seq=8)
    prompt = np.random.default_rng(7).integers(0, vocab, size=24)
    sreq = ns.serve.ServeRequest(req_id=0, prompt=prompt.astype(np.int32),
                                 max_new_tokens=8)
    ref = engine(ns, models, **big)
    ref.submit(copy.deepcopy(sreq))
    ref_out = outputs(ref.run())
    e_small, e_big = engine(ns, models, **small), engine(ns, models, **big)
    router = ns.serve.ReplicaRouter(
        [e_small.as_replica(0), e_big.as_replica(1)], migrate_after=2)
    router.submit(copy.deepcopy(sreq))
    assert router.counters.get("reach_redirects") == 1
    s0, s1 = e_small.scheduler, e_big.scheduler
    steps = 0
    while not (0 in s1.running and s1.vmem.config.pages_for(
            s1.vmem.seq_len(0)) > s0.attainable_pages()):
        steps += 1
        assert steps < 100
        router.step()
    pages = list(s1.vmem.seq(0).pages)
    kv = e_big.executor.kv
    victim = np.stack([np.asarray(kv.k_pools)[:, pages],
                       np.asarray(kv.v_pools)[:, pages]])
    if seed_kv is not None:
        assert pages == seed_kv[0]
        tol = 0 if kv_dtype == "int8" else 1e-5
        np.testing.assert_allclose(victim, seed_kv[1], atol=tol, rtol=tol)
        rows = torch.as_tensor(pages)
        kv.k_pools[:, rows] = torch.from_numpy(seed_kv[1][0])
        kv.v_pools[:, rows] = torch.from_numpy(seed_kv[1][1])
    s1.spill(s1.running[0])
    exp = s1.export_swapped(0)
    record = np.asarray(exp.record.page_data)
    s0.import_swapped(exp)
    assert e_small.switcher.swapped_out == [0]
    done = router.run()
    assert router.counters.get("restore_migrations") == 1
    assert router.global_counters()["failed_unreachable"] == 0
    assert outputs(done) == ref_out
    assert e_small.switcher.swapped_out == e_big.switcher.swapped_out == []
    assert_accounting(router)
    out = engine_summary(summary(router), (e_small, e_big))
    for e in (ref, e_small, e_big):
        e.close()
    return out, record, (pages, victim)


def test_real_n2_router_matches_jax(models):
    both(real_n2, models)


def test_real_leak_audit_matches_jax(models):
    both(real_leak_audit, models)


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_real_rescue_record_bit_identical_to_jax(models, kv_dtype):
    want, want_rec, victim = real_rescue(JAX, models, kv_dtype)
    got, got_rec, _ = real_rescue(PORT, models, kv_dtype, seed_kv=victim)
    assert got == want
    assert got_rec.dtype == want_rec.dtype == (
        np.int8 if kv_dtype == "int8" else np.float32)
    assert got_rec.shape == want_rec.shape
    np.testing.assert_array_equal(got_rec.view(np.uint8),
                                  want_rec.view(np.uint8))

"""The paper's virtual-memory loop in the port against the JAX package.

On identical numpy inputs, made from seeds:

  * ``paged_gather``: the port's plain route is bit-identical to the JAX
    Pallas kernel (interpret mode, one grid step per element, so N stays
    small) and to the JAX oracle in f32, bf16 and int8, in any order, with
    repeats and -1 entries; positions past the table's reach against the
    oracle only (the Pallas kernel's table read is out of bounds there);
    ``paged_gather_coalesced`` equals JAX's; the copy -> gather round trip
    holds.
  * ``matmul``: the port against JAX ``ops.matmul`` (interpret) within the
    JAX test's own tolerances (f32 2e-4, bf16 2e-2; 1e-4 for its block
    sweep), on its shapes, the paper's n = 45 / 90 / 181 and a bf16
    output.
  * ``tlb``: the port's ``SharedMMUSimulator`` gives a report equal field
    for field to JAX's on the quickstart, translation and matmul traces
    over the 2..128-entry sweep; pollution and ``interleave`` agree; the
    JAX ``TestTLB`` / ``TestPLRUvsTrueLRU`` properties as seeded cases.
  * the quickstart prints exactly the JAX example's lines.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here the checks and the device dispatch are tested.
"""

import contextlib
import dataclasses
import functools
import io
import pathlib
import runpy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.bench_tlb_sweep import TLB_SIZES, matmul_trace
from repro.core import VMemConfig as JVMemConfig
from repro.core import VirtualMemory as JVirtualMemory
from repro.core import burst_trace as j_burst_trace
from repro.core import element_trace as j_element_trace
from repro.core import tlb as jtlb
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import VMemConfig, VirtualMemory, burst_trace, element_trace
from repro_torch.core import tlb as ttlb
from repro_torch.kernels import ops, ref
from repro_torch.kernels.matmul import matmul as matmul_kernel
from repro_torch.kernels.paged_gather import paged_gather as gather_kernel
from repro_torch.launch import quickstart

pytestmark = pytest.mark.torch_port

ROOT = pathlib.Path(__file__).resolve().parents[1]
DTYPES = {"f32": (np.float32, torch.float32, jnp.float32),
          "bf16": (np.float32, torch.bfloat16, jnp.bfloat16),
          "int8": (np.int8, torch.int8, jnp.int8)}


def both(a, dtype: str):
    """The same numpy array as a torch tensor and a jax array of ``dtype``
    (bf16 rounds from f32 to nearest even on both sides)."""
    _, td, jd = DTYPES[dtype]
    return torch.from_numpy(np.array(a)).to(td), jnp.asarray(a).astype(jd)


def as_np(x):
    """f32 (or int8) numpy of a torch tensor or jax array, exactly."""
    if isinstance(x, torch.Tensor):
        return (x if x.dtype == torch.int8 else x.float()).numpy()
    return np.asarray(x if x.dtype == jnp.int8 else x.astype(jnp.float32))


# ---------------------------------------------------------------------------
# paged_gather
# ---------------------------------------------------------------------------


def gather_case(seed, dtype, *, w, page=4, frames=12, max_pages=5, n=12,
                past=0):
    """A pool, one table row with a -1 entry, ``n`` positions in random
    order with repeats, the first ``past`` of them past the reach."""
    rng = np.random.default_rng(seed)
    shape = (frames, page, w)
    if dtype == "int8":
        pool = rng.integers(-127, 128, shape).astype(np.int8)
    else:
        pool = (rng.standard_normal(shape) * 50).astype(np.float32)
    row = rng.permutation(frames)[:max_pages].astype(np.int32)
    row[2] = -1
    pos = rng.integers(0, max_pages * page, n).astype(np.int32)
    pos[-1] = pos[0]
    pos[-2] = pos[1]
    pos[:past] = max_pages * page + np.array([0, 5, 17, 3 * page])[:past]
    return pool, row, pos, page


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("w", [4, 14])
def test_gather_bit_identical_to_pallas_kernel_and_oracle(dtype, w):
    pool, row, pos, page = gather_case(1, dtype, w=w)
    tp, jp = both(pool, dtype)
    got = ops.paged_gather(tp, torch.from_numpy(row), torch.from_numpy(pos),
                           page_size=page)
    args = (jp, jnp.asarray(row), jnp.asarray(pos))
    kernel = jops.paged_gather(*args, page_size=page)
    oracle = jref.paged_gather_ref(*args, page_size=page)
    assert got.dtype == tp.dtype and got.shape == (pos.size, w)
    np.testing.assert_array_equal(as_np(got), as_np(kernel))
    np.testing.assert_array_equal(as_np(got), as_np(oracle))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gather_past_the_reach_matches_oracle(dtype):
    """A position past the table reads its last entry (jnp's clamp)."""
    pool, row, pos, page = gather_case(2, dtype, w=6, n=24, past=4)
    tp, jp = both(pool, dtype)
    got = ops.paged_gather(tp, torch.from_numpy(row), torch.from_numpy(pos),
                           page_size=page)
    want = jref.paged_gather_ref(jp, jnp.asarray(row), jnp.asarray(pos),
                                 page_size=page)
    np.testing.assert_array_equal(as_np(got), as_np(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gather_coalesced_matches_jax(dtype):
    pool, row, pos, page = gather_case(3, dtype, w=8, n=40)
    tp, jp = both(pool, dtype)
    got = ops.paged_gather_coalesced(tp, torch.from_numpy(row),
                                     torch.from_numpy(pos), page_size=page)
    want = jops.paged_gather_coalesced(jp, jnp.asarray(row), jnp.asarray(pos),
                                       page_size=page)
    np.testing.assert_array_equal(as_np(got), as_np(want))
    plain = ops.paged_gather(tp, torch.from_numpy(row), torch.from_numpy(pos),
                             page_size=page)
    assert torch.equal(got, plain)


def scrambled_row(vm_cls, cfg_cls, *table_device, page, frames, tokens):
    """``tokens`` mapped after ``frames`` one-page decoys left in a random
    order, so the LIFO free list hands out scrambled frames (as
    ``chip_smoke.py``'s gather phase maps its sequence); the table row as
    numpy (``table_device``: the port's table is built on a device)."""
    vm = vm_cls(cfg_cls(page_size=page, num_pages=frames,
                        max_pages_per_seq=tokens // page,
                        max_seqs=frames + 1))
    for i in range(frames):
        vm.map_seq(i + 1, page)
    for i in np.random.default_rng(6).permutation(frames):
        vm.unmap_seq(int(i) + 1)
    seq = vm.map_seq(0, tokens)
    return np.asarray(vm.device_page_table(*table_device)[seq.slot]).astype(
        np.int32)


def translation_streams(tokens):
    """``benchmarks/bench_translation.py``'s four streams."""
    rng = np.random.default_rng(0)
    return {
        "unit_stride": np.arange(tokens),
        "strided_4": np.arange(0, tokens, 4),
        "random": rng.integers(0, tokens, size=tokens),
        "sorted_random": np.sort(rng.integers(0, tokens, size=tokens)),
    }


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("stream", ["unit_stride", "strided_4", "random",
                                    "sorted_random"])
def test_gather_translation_streams_match_pallas_kernel(dtype, stream):
    """The four streams of ``bench_translation.py`` over a 256-token
    sequence in scrambled frames (both packages' VMs hand out the same
    frames): ``ops.paged_gather`` bit-identical to the Pallas kernel
    (interpret) and to the JAX oracle."""
    page, frames, tokens, w = 16, 24, 256, 64
    row = scrambled_row(VirtualMemory, VMemConfig, "cpu", page=page,
                        frames=frames, tokens=tokens)
    np.testing.assert_array_equal(
        row, scrambled_row(JVirtualMemory, JVMemConfig, page=page,
                           frames=frames, tokens=tokens))
    assert np.all(row >= 0) and len(set(row.tolist())) == tokens // page
    assert np.sum(np.abs(np.diff(row)) == 1) < tokens // page // 2
    pos = translation_streams(tokens)[stream].astype(np.int32)
    rng = np.random.default_rng(5)
    if dtype == "int8":
        pool = rng.integers(-127, 128, (frames, page, w)).astype(np.int8)
    else:
        pool = (rng.standard_normal((frames, page, w)) * 50).astype(np.float32)
    tp, jp = both(pool, dtype)
    got = ops.paged_gather(tp, torch.from_numpy(row), torch.from_numpy(pos),
                           page_size=page)
    args = (jp, jnp.asarray(row), jnp.asarray(pos))
    assert got.shape == (pos.size, w) and got.dtype == tp.dtype
    np.testing.assert_array_equal(
        as_np(got), as_np(jops.paged_gather(*args, page_size=page)))
    np.testing.assert_array_equal(
        as_np(got), as_np(jref.paged_gather_ref(*args, page_size=page)))


@pytest.mark.parametrize("lens", [[1], [60], [13, 7, 40], [8, 16, 64]])
def test_copy_gather_roundtrip(lens):
    """write-through-translation then read-through-translation == id
    (``tests/test_kernels.py``'s round trip, on the port)."""
    vm = VirtualMemory(VMemConfig(page_size=8, num_pages=64,
                                  max_pages_per_seq=8, max_seqs=len(lens)))
    for i, n in enumerate(lens):
        vm.map_seq(i, n)
    w = 4
    src = torch.from_numpy(np.random.default_rng(0).normal(
        size=(len(lens), max(lens), w)).astype(np.float32))
    pool = torch.zeros((64, 8, w))
    table = vm.device_page_table("cpu")
    ops.paged_copy(src, pool, table, torch.tensor(lens, dtype=torch.int32),
                   page_size=8)
    for i, n in enumerate(lens):
        got = ops.paged_gather(pool, table[i],
                               torch.arange(n, dtype=torch.int32),
                               page_size=8)
        assert torch.equal(got, src[i, :n])


def test_gather_checks():
    pool = torch.zeros((4, 8, 6))
    row = torch.zeros(3, dtype=torch.int32)
    pos = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(TypeError):                       # f16 pool
        ops.paged_gather(pool.half(), row, pos, page_size=8)
    with pytest.raises(TypeError):                       # int64 positions
        ops.paged_gather(pool, row, pos.long(), page_size=8)
    with pytest.raises(ValueError):                      # page size
        ops.paged_gather(pool, row, pos, page_size=4)
    with pytest.raises(ValueError):                      # a 2-D table
        ops.paged_gather(pool, row[None], pos, page_size=8)
    with pytest.raises(ValueError):                      # an empty table
        ops.paged_gather(pool, row[:0], pos, page_size=8)
    with pytest.raises(ValueError):                      # strided positions
        ops.paged_gather(pool, row, torch.zeros(10, dtype=torch.int32)[::2],
                         page_size=8)
    with pytest.raises(ValueError):                      # two devices
        ops.paged_gather(pool.to("meta"), row, pos, page_size=8)
    with pytest.raises(ValueError):                      # CUDA only
        gather_kernel(pool, row, pos, page_size=8)
    with pytest.raises(TypeError):                       # coalesced checks too
        ops.paged_gather_coalesced(pool, row.long(), pos, page_size=8)


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------


def mm_case(seed, m, k, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("m,k,n", [
    (128, 128, 128), (256, 384, 128), (128, 512, 256),
    (100, 70, 50), (1, 128, 128), (8, 1024, 8),
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_matmul_matches_jax(m, k, n, dtype):
    x, y = mm_case(m * k + n, m, k, n)
    (tx, jx), (ty, jy) = both(x, dtype), both(y, dtype)
    got = ops.matmul(tx, ty, out_dtype=torch.float32)
    want = jops.matmul(jx, jy, out_dtype=jnp.float32)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    close(got, want, 2e-4 if dtype == "f32" else 2e-2)


@pytest.mark.parametrize("n", [45, 90, 181])
def test_matmul_paper_sizes_f32(n):
    """The three problems of ``benchmarks/bench_tlb_sweep.PROBLEMS``."""
    x, y = mm_case(n, n, n, n)
    got = ops.matmul(torch.from_numpy(x), torch.from_numpy(y))
    want = jops.matmul(jnp.asarray(x), jnp.asarray(y))
    assert got.dtype == torch.float32
    close(got, want, 2e-4)


@pytest.mark.parametrize("bm,bn,bk", [(64, 64, 64), (128, 256, 64),
                                      (256, 128, 256)])
def test_matmul_against_each_jax_block_shape(bm, bn, bk):
    """JAX's block sweep: the port has no block arguments, so each JAX
    tiling of the same 256x256 product is one case."""
    x, y = mm_case(7, 256, 256, 256)
    got = ops.matmul(torch.from_numpy(x), torch.from_numpy(y))
    want = jops.matmul(jnp.asarray(x), jnp.asarray(y), bm=bm, bn=bn, bk=bk)
    close(got, want, 1e-4)
    close(got, x @ y, 1e-4)


def test_matmul_bf16_output():
    x, y = mm_case(9, 100, 70, 50)
    (tx, jx), (ty, jy) = both(x, "bf16"), both(y, "bf16")
    got = ops.matmul(tx, ty)
    want = jops.matmul(jx, jy)
    assert got.dtype == torch.bfloat16
    close(got, want, 2e-2)
    # one rounding of the f32 sums, at the end
    assert torch.equal(got, ops.matmul(tx, ty, out_dtype=torch.float32)
                       .to(torch.bfloat16))


def test_matmul_checks():
    x, y = torch.zeros(4, 3), torch.zeros(3, 5)
    with pytest.raises(TypeError):                       # mixed dtypes
        ops.matmul(x, y.bfloat16())
    with pytest.raises(TypeError):                       # an int product
        ops.matmul(x.int(), y.int())
    with pytest.raises(TypeError):                       # f16 output
        ops.matmul(x, y, out_dtype=torch.float16)
    with pytest.raises(ValueError):                      # contraction
        ops.matmul(x, y.T.contiguous())
    with pytest.raises(ValueError):                      # a transposed view
        ops.matmul(x, torch.zeros(5, 3).T)
    with pytest.raises(ValueError):                      # two devices
        ops.matmul(x.to("meta"), y)
    with pytest.raises(ValueError):                      # CUDA only
        matmul_kernel(x, y)


# ---------------------------------------------------------------------------
# the DTLB simulator
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def translation_traces():
    """``benchmarks/bench_translation.py``'s four streams at 4096 tokens,
    each as burst, element and coalesced traces, from both packages."""
    page, tokens = 16, 4096
    rng = np.random.default_rng(0)
    streams = {
        "unit_stride": np.arange(tokens),
        "strided_4": np.arange(0, tokens, 4),
        "random": rng.integers(0, tokens, size=tokens),
        "sorted_random": np.sort(rng.integers(0, tokens, size=tokens)),
    }
    out = {}
    for name, pos in streams.items():
        for label, port, jx in (
                ("burst", burst_trace(pos, page), j_burst_trace(pos, page)),
                ("element", element_trace(pos, page),
                 j_element_trace(pos, page)),
                ("coalesced", burst_trace(np.sort(pos), page),
                 j_burst_trace(np.sort(pos), page))):
            np.testing.assert_array_equal(port, jx)
            out[f"{name}_{label}"] = port
    return out


@functools.lru_cache(maxsize=None)
def events(trace: str):
    """(port events, JAX events) of one named trace."""
    if trace.startswith("matmul_"):
        jev, _ = matmul_trace(int(trace.split("_")[1]))
        return [ttlb.AccessEvent(e.source, e.vpn, e.slack) for e in jev], jev
    if trace == "quickstart":
        vpns, slack = element_trace(np.tile(np.arange(80), 20), 8), 5.0
    else:
        vpns, slack = translation_traces()[trace], 4.0
    return ([ttlb.AccessEvent(ttlb.VECTOR, int(v), slack) for v in vpns],
            [jtlb.AccessEvent(jtlb.VECTOR, int(v), slack) for v in vpns])


TRACES = ["quickstart"] + [
    f"{s}_{k}" for s in ("unit_stride", "strided_4", "random", "sorted_random")
    for k in ("burst", "element", "coalesced")]
CASES = ([(t, e) for t in TRACES + ["matmul_45", "matmul_90"]
          for e in TLB_SIZES] + [("matmul_181", 16), ("matmul_181", 128)])


@pytest.mark.parametrize("trace,entries", CASES,
                         ids=[f"{t}-{e}" for t, e in CASES])
def test_simulator_report_equals_jax(trace, entries):
    port_ev, jax_ev = events(trace)
    got = ttlb.SharedMMUSimulator(entries).run(port_ev)
    want = jtlb.SharedMMUSimulator(entries).run(jax_ev)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.translations == len(port_ev) > 0


@pytest.mark.parametrize("entries", [2, 8, 32])
@pytest.mark.parametrize("seed", [0, 5])
def test_pollution_matches_jax(entries, seed):
    port_ev, jax_ev = events("random_element")
    kw = dict(pollution_evictions_per_tick=3, num_ticks=16)
    got = ttlb.SharedMMUSimulator(entries, seed=seed).run(port_ev, **kw)
    want = jtlb.SharedMMUSimulator(entries, seed=seed).run(jax_ev, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.mux_pollution_cycles > 0


@pytest.mark.parametrize("ratio", [1, 3])
def test_interleave_matches_jax(ratio):
    rng = np.random.default_rng(ratio)
    s, v = rng.integers(0, 9, 23), rng.integers(0, 9, 11)
    kw = dict(scalar_slack=2.0, vector_slack=7.0, ratio=ratio)
    got = [dataclasses.astuple(e) for e in ttlb.interleave(s, v, **kw)]
    want = [dataclasses.astuple(e) for e in jtlb.interleave(s, v, **kw)]
    assert got == want and len(got) == 34
    rep = ttlb.SharedMMUSimulator(4).run(ttlb.interleave(s, v, **kw))
    jrep = jtlb.SharedMMUSimulator(4).run(jtlb.interleave(s, v, **kw))
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)


# The JAX TestTLB / TestPLRUvsTrueLRU properties, as seeded cases.


def test_tlb_power_of_two_enforced():
    with pytest.raises(ValueError):
        ttlb.TLB(3)


def test_tlb_residency_bounded():
    t = ttlb.TLB(4)
    for v in range(100):
        t.access(v)
    assert len(t.resident) <= 4


def test_tlb_warm_working_set_never_misses():
    t = ttlb.TLB(8)
    for v in range(6):
        t.access(v)
    h0, m0 = t.hits, t.misses
    for _ in range(10):
        for v in range(6):
            assert t.access(v)
    assert t.misses == m0 and t.hits == h0 + 60


def test_tlb_plru_evicts_cold_entry():
    """After touching 1,2,3,4 then re-touching 1,2 the victim is 3."""
    t = ttlb.TLB(4)
    for v in [1, 2, 3, 4, 1, 2]:
        t.access(v)
    t.access(5)
    assert {1, 2, 4, 5} == t.resident


def test_tlb_flush():
    t = ttlb.TLB(4)
    t.access(1)
    t.flush()
    assert not t.access(1)


def test_tlb_pollution_evicts_but_hides_stats():
    t = ttlb.TLB(4)
    for v in range(4):
        t.access(v)
    h, m = t.hits, t.misses
    t.pollute(4, np.random.default_rng(0))
    assert (t.hits, t.misses) == (h, m)
    assert not t.resident & {0, 1, 2, 3}


@pytest.mark.parametrize("entries", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("seed", range(3))
def test_tlb_hits_plus_misses_is_accesses(entries, seed):
    rng = np.random.default_rng(seed)
    trace = rng.integers(0, 31, int(rng.integers(1, 301))).tolist()
    t, jt = ttlb.TLB(entries), jtlb.TLB(entries)
    for v in trace:
        assert t.access(v) == jt.access(v)
    assert t.hits + t.misses == len(trace)
    assert t.misses >= min(len(set(trace)), 1)
    assert t.resident == jt.resident


@pytest.mark.parametrize("n_pages", [1, 7, 64])
def test_tlb_full_residency_eliminates_capacity_misses(n_pages):
    """Paper: at 128 PTEs all workload pages fit and misses ~vanish."""
    t = ttlb.TLB(128)
    for v in list(range(n_pages)) * 5:
        t.access(v)
    assert t.misses == n_pages


def true_lru_misses(trace, entries):
    order, misses = [], 0
    for v in trace:
        if v in order:
            order.remove(v)
        else:
            misses += 1
            if len(order) >= entries:
                order.pop(0)
        order.append(v)
    return misses


@pytest.mark.parametrize("seed", range(4))
def test_plru_equals_lru_for_two_ways(seed):
    rng = np.random.default_rng(100 + seed)
    trace = rng.integers(0, 7, int(rng.integers(1, 121))).tolist()
    t = ttlb.TLB(2)
    for v in trace:
        t.access(v)
    assert t.misses == true_lru_misses(trace, 2)


@pytest.mark.parametrize("entries", [4, 8, 16])
@pytest.mark.parametrize("seed", range(3))
def test_plru_within_2x_of_lru(entries, seed):
    rng = np.random.default_rng(200 + seed)
    trace = rng.integers(0, 21, int(rng.integers(10, 201))).tolist()
    t = ttlb.TLB(entries)
    for v in trace:
        t.access(v)
    assert t.misses <= max(2 * true_lru_misses(trace, entries),
                           len(set(trace)))


# ---------------------------------------------------------------------------
# the slice as a whole, and the dispatch
# ---------------------------------------------------------------------------


def stdout_of(fn) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


def test_quickstart_prints_the_jax_example_lines():
    example = runpy.run_path(str(ROOT / "examples" / "quickstart.py"),
                             run_name="quickstart_example")
    want = stdout_of(example["main"])
    got = stdout_of(lambda: quickstart.main(device="cpu"))
    assert len(want) == 11
    assert got == want


def test_vm_matches_jax_on_the_quickstart_mapping():
    cfg = dict(page_size=8, num_pages=64, max_pages_per_seq=16, max_seqs=2)
    vm, jvm = VirtualMemory(VMemConfig(**cfg)), JVirtualMemory(
        JVMemConfig(**cfg))
    for v in (vm, jvm):
        v.map_seq(0, 50)
        v.append_tokens(0, 30)
    np.testing.assert_array_equal(vm.device_page_table("cpu").numpy(),
                                  np.asarray(jvm.device_page_table()))


def test_cpu_dispatch_launches_no_kernel():
    ops.reset_launch_counts()
    pool, row, pos, page = gather_case(4, "f32", w=4)
    args = (torch.from_numpy(pool), torch.from_numpy(row),
            torch.from_numpy(pos))
    a = ops.paged_gather(*args, page_size=page)
    b = ops.paged_gather(*args, page_size=page, use_kernel=False)
    assert torch.equal(a, b)
    assert torch.equal(a, ref.paged_gather_ref(*args, page_size=page))
    x, y = mm_case(5, 9, 7, 5)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    assert torch.equal(ops.matmul(tx, ty), ops.matmul(tx, ty,
                                                      use_kernel=False))
    assert torch.equal(ops.matmul(tx, ty), ref.matmul_ref(tx, ty))
    counts = ops.launch_counts()
    assert counts["paged_gather"] == 0 and counts["matmul"] == 0
    assert not any(counts.values())

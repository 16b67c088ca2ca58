"""The open loop end to end on the CPU at a tiny size: it runs the
window, every metric reader finds its numbers, the latencies come from
the harness's own stamps, and the check passes on sound runs."""

import math

import pytest

from portbench.lib import serve, spec

import tiny


def _run(**kw):
    return spec.module("traffic", "open").run(
        tiny.ctx(tiny.DENSE, tiny.OPEN, "qwen2-7b.chat", **kw))


@pytest.fixture(scope="module")
def open_run():
    return _run()


def test_open_loop_result(open_run):
    out = open_run
    assert out["check"]["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] >= 3
    assert math.isfinite(out["e2e"]["ttft_p95_ms"])
    assert out["e2e"]["tpot_p95_ms"] > 0
    rec = out["record"]
    assert rec["window_s"] > 0.5          # step boundaries near 1 s
    kinds = {s["kind"] for s in rec["steps"]}
    assert kinds <= {"prefill", "decode", "idle"} and "prefill" in kinds
    # the decoded positions the recorder saw are the engine's decode tokens
    assert sum(len(s["decode"]) for s in rec["steps"]) > 0
    assert out["check"]["readings"]["requests"] >= 4


@pytest.mark.parametrize("name,lo,hi", [
    ("host_syncs_per_token.open", 0.0, float("inf")),
    ("prefix_skip_pct.shared", -1.0, 100.0)])
def test_open_loop_counter_readers(open_run, name, lo, hi):
    """Each counter reader finds its counters in the window.  Whether a
    shared prompt is still resident when its next request comes is timing
    at this size (a finished request's pages leave the radix cache), so
    the skipped share may read 0 here; its arithmetic is checked by hand
    below."""
    v = spec.module("metrics", name).read(open_run["record"])
    assert v is not None and lo < v <= hi


def test_prefix_skip_reader_by_hand():
    read = spec.module("metrics", "prefix_skip_pct.shared").read
    rec = dict(counters=dict(prefill_tokens_skipped=32, prefill_tokens=48,
                             continuation_prefill_tokens=16))
    assert read(rec) == pytest.approx(100 * 32 / 96)
    assert read(dict(counters=dict(decode_tokens=5))) is None


def test_step_share_readers_by_hand():
    """The step shares on a record worked by hand: one prefill step and
    one decode-only step of 10 ms each in a 50 ms window."""
    dims = spec.dims(spec.load_json(spec.PKG / "configs" / "qwen2-7b.json"))
    tr = spec.module("work", "transformer")
    pre = dict(kind="prefill", t0=0.0, t1=0.01, chunks=[(0, 100)],
               decode=[101], lanes=[1])
    dec = dict(kind="decode", t0=0.02, t1=0.03, chunks=[],
               decode=[102, 50], lanes=[2])
    rec = dict(steps=[pre, dec], window_s=0.05, dims=dims, counters={})
    peak = 989e12
    assert spec.module("metrics", "decode_mfu.open").read(rec) == \
        pytest.approx(100 * tr.step(dims, dec) / (0.01 * peak))
    assert spec.module("metrics", "prefill_mfu.open").read(rec) == \
        pytest.approx(100 * tr.step(dims, pre) / (0.01 * peak))
    assert spec.module("metrics", "decode_mfu.open").read(
        dict(rec, steps=[pre])) is None


@pytest.mark.parametrize("name", ["idle_pct.open", "flash_attention_roofline",
                                  "paged_decode_attention_roofline"])
def test_trace_readers_silent_without_a_trace(open_run, name):
    assert spec.module("metrics", name).read(open_run["record"]) is None


def test_recorder_stamps_first_and_last_commit():
    """A request's first and last token are stamped with the return time
    of the step that committed them."""
    class Req:
        def __init__(self):
            self.output, self.status = [], "running"
            self.prefix_len, self.prompt = 0, [1, 2, 3]

    class Eng:
        def __init__(self):
            self.r = Req()
            self.queue, self.running = [self.r], {}
            self.counters = type("C", (), dict(counters=dict.fromkeys(
                serve.STEP_COUNTERS, 0)))()
            self.n = 0

        def submit(self, req):
            return 0

        def step(self):
            self.n += 1
            if self.n == 1:              # admitted, no token yet
                self.running[0] = self.r
            elif self.n <= 3:            # one token, then two more
                self.r.output += [7] * (self.n - 1)
            else:                        # retired: nothing committed
                self.r.status = "done"
                del self.running[0]

    rec = serve.Recorder(Eng())
    rec.submit([1, 2, 3], 3)
    t1 = [rec.step() and rec.spans[-1][2] for _ in range(4)]
    assert rec.t_first[0] == t1[1] and rec.t_last[0] == t1[2]
    assert rec.committed == 3


def test_latencies_ignore_the_programs_stamps(monkeypatch):
    """The program's own commit stamps moved a thousand seconds early: the
    tails, from the harness's stamps, stay what they are."""
    from repro_torch.serve.scheduler import Scheduler
    stamp = Scheduler._stamp_commit

    def early(self, req, now):
        stamp(self, req, now - 1000.0)
    monkeypatch.setattr(Scheduler, "_stamp_commit", early)
    out = _run(seed=4)
    assert out["check"]["correct"], out["check"]
    assert 0 < out["e2e"]["ttft_p95_ms"] < 1e5
    assert 0 < out["e2e"]["tpot_p95_ms"] < 1e5

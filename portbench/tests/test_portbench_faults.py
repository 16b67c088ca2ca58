"""The check fails a run whose timed path is broken underneath: the rest
of a run (the harness's look for a card skipped) with a fault planted in
the port, once for each fault a serve cell can have (half a batch left
out and the exchange between chips are training's and the mesh's)."""

import pytest
import torch

from portbench.lib import spec

import tiny


def _altered_tokens(monkeypatch):
    """A token altered where it is produced: every lane's first token of
    each decode dispatch is shifted by one."""
    from repro_torch.serve.executor import Executor
    multi, single = Executor.decode_multi, Executor.decode

    def decode_multi(self, plan):
        out = multi(self, plan)
        out[0] = (out[0] + 1) % self.model.cfg.vocab_size
        return out

    def decode(self, tokens, pre_lens, active):
        out = single(self, tokens, pre_lens, active)
        return (out + 1) % self.model.cfg.vocab_size
    monkeypatch.setattr(Executor, "decode_multi", decode_multi)
    monkeypatch.setattr(Executor, "decode", decode)


def _state_unchanged(monkeypatch):
    """A decode step that returns its state unchanged: the new token's K and
    V never reach the pools."""
    from repro_torch.models.transformer import TransformerLM
    step = TransformerLM.decode_step

    def decode_step(self, params, tokens, state):
        k, v = state.k_pools.clone(), state.v_pools.clone()
        out = step(self, params, tokens, state)
        state.k_pools.copy_(k)
        state.v_pools.copy_(v)
        return out
    monkeypatch.setattr(TransformerLM, "decode_step", decode_step)


@pytest.mark.parametrize("fault", [_altered_tokens, _state_unchanged])
def test_fault_fails_the_check(monkeypatch, fault):
    fault(monkeypatch)
    out = spec.module("traffic", "open").run(
        tiny.ctx(tiny.DENSE, tiny.OPEN, "qwen2-7b.shared-prefix",
                 seconds=1.0))
    assert not out["check"]["correct"], out["check"]
    num = out["check"]["numbers"]["mean_gap"]
    assert num["value"] > num["limit"]


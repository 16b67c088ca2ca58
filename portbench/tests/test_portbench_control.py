"""The control at a size a test run holds: the plain reference computed in
float8 (weights and activations of every linear layer) put in the
program's place, read at each position the sound program served.  The
harness's own comparison has to judge it not correct, while the sound
program's served tokens, read in the same pass, are within the limits."""

import pytest

from portbench.lib import spec

import tiny


@pytest.mark.parametrize("seed,mix,cell", [
    (1, tiny.OPEN, "qwen2-7b.shared-prefix"),
    (2, dict(tiny.OPEN, prefixes=None), "qwen2-7b.chat"),
    (3, tiny.OPEN, "qwen2-7b.shared-prefix")])
def test_control_fails_the_check(seed, mix, cell):
    """On three seeds the check returns ``correct`` false for the control,
    with a number it compared above its limit, and the sound program's
    own gaps from the same run within every limit."""
    out = spec.module("traffic", "open").run(
        tiny.ctx(tiny.DENSE, mix, cell, seed=seed, seconds=1.0,
                 fp8_control=True))
    chk, lim = out["check"], tiny.LIMITS["tiny-dense"]
    assert not chk["correct"], chk
    nums = chk["numbers"]
    assert any(nums[k]["value"] > nums[k]["limit"] for k in lim), nums
    for k, v in lim.items():
        assert nums[k]["value"] == chk["readings"][f"{k}_fp8"]
        assert chk["readings"][k] <= v, chk["readings"]
    assert nums["failed_requests"]["value"] == 0

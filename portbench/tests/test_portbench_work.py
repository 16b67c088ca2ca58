"""Each ``work/`` count against a shape worked by hand."""

import pytest

from portbench.lib import peaks, spec

QWEN = spec.dims(spec.load_json(spec.PKG / "configs" / "qwen2-7b.json"))
#: an MoE decoder's sizes (granite-3.0-1b-a400m's published widths), for
#: the MoE branch of the model FLOPs
MOE = spec.dims(dict(
    family="moe", num_hidden_layers=24, hidden_size=1024,
    num_attention_heads=16, num_key_value_heads=8, intermediate_size=512,
    vocab_size=49155, num_local_experts=32, num_experts_per_tok=8,
    rms_norm_eps=1e-6, rope_theta=10000.0))


def test_dims_from_published_keys():
    assert (QWEN["layers"], QWEN["d"], QWEN["heads"], QWEN["kv_heads"],
            QWEN["head_dim"], QWEN["ffn"], QWEN["vocab"]) == \
        (28, 3584, 28, 4, 128, 18944, 152064)
    assert (MOE["experts"], MOE["top_k"], MOE["head_dim"]) == (32, 8, 64)


def test_transformer_flops_by_hand():
    tr = spec.module("work", "transformer")
    # qwen2-7b: q 3584x3584, k and v 3584x512, o 3584x3584, FFN 3 x
    # 3584x18944, two FLOPs a multiply-add, 28 layers
    per_layer = 2 * (3584 * 3584 * 2 + 3584 * 512 * 2 + 3 * 3584 * 18944)
    assert tr.linear_per_token(QWEN) == 28 * per_layer
    assert tr.head(QWEN) == 2 * 3584 * 152064
    # MoE: 8 of 32 experts of 3 x 1024x512, router 1024x32
    g_layer = (2 * (1024 * 1024 * 2 + 1024 * 512 * 2)
               + 2 * 3 * 1024 * 512 * 8 + 2 * 1024 * 32)
    assert tr.linear_per_token(MOE) == 24 * g_layer
    # a 3-token chunk from 0 attends 1 + 2 + 3 keys; from 10, 11 + 12 + 13
    assert tr.causal_keys(0, 3) == 6
    assert tr.causal_keys(10, 3) == 36
    st = dict(chunks=[(0, 3)], decode=[7, 9])
    want = (3 * tr.linear_per_token(QWEN) + tr.head(QWEN)
            + 4 * 3584 * 28 * 6
            + 2 * (tr.linear_per_token(QWEN) + tr.head(QWEN))
            + 4 * 3584 * 28 * 16)
    assert tr.step(QWEN, st) == want


def test_paged_decode_attention_by_hand():
    w = spec.module("work", "paged_decode_attention")
    steps = [dict(kind="decode", chunks=[], decode=[100, 200], lanes=[2])]
    flops, nbytes = w.work(QWEN, steps)
    assert flops == 4 * 3584 * 300 * 28
    # K and V: 512 elements a token each; q and out 3584 a token; bf16
    assert nbytes == 2 * 28 * (2 * 512 * 300 + 2 * 3584 * 2)


def test_flash_and_paged_prefill_by_hand():
    fl = spec.module("work", "flash_attention")
    pp = spec.module("work", "paged_prefill_attention")
    steps = [dict(kind="prefill", chunks=[(0, 4), (16, 2)], decode=[],
                  lanes=[])]
    f, b = fl.work(QWEN, steps)
    assert f == 4 * 3584 * 10 * 28                      # 1+2+3+4 keys
    assert b == 2 * 28 * 4 * (2 * 3584 + 2 * 512)
    f, b = pp.work(QWEN, steps)
    assert f == 4 * 3584 * (17 + 18) * 28
    assert b == 2 * 28 * (2 * 3584 * 2 + 2 * 512 * 18)


def test_bound_is_the_larger_term():
    assert peaks.bound_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)

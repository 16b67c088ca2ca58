"""The one place the harness builds the system under test, the port
(``repro_torch``), from a configuration file: its model, serve
configuration and engine."""

from __future__ import annotations

import torch


def model_config(conf: dict, dims: dict):
    from repro_torch.models.config import ModelConfig
    moe = bool(dims["experts"])
    return ModelConfig(
        name=conf["name"], family="moe" if moe else "dense",
        num_layers=dims["layers"], d_model=dims["d"],
        num_heads=dims["heads"], num_kv_heads=dims["kv_heads"],
        d_ff=dims["ffn"], vocab_size=dims["vocab"],
        head_dim=dims["head_dim"], qkv_bias=dims["qkv_bias"],
        num_experts=dims["experts"], experts_per_token=dims["top_k"],
        moe_d_ff=dims["ffn"] if moe else 0, rope_theta=dims["rope_theta"],
        norm_eps=dims["norm_eps"], param_dtype=conf["torch_dtype"],
        tie_embeddings=False)


def build_model(conf: dict, dims: dict, device, **kw):
    from repro_torch.models.transformer import TransformerLM
    return TransformerLM(model_config(conf, dims), device=device, **kw)


def engine(model, params, serve: dict, num_pages: int, max_pages: int,
           kv_dtype: str = "native"):
    from repro_torch.serve import Engine, ServeConfig
    cfg = ServeConfig(page_size=serve["page_size"], num_pages=num_pages,
                      max_pages_per_seq=max_pages,
                      max_batch=serve["max_batch"],
                      max_horizon=serve["max_horizon"],
                      prefix_cache=serve["prefix_cache"], greedy=True,
                      kv_dtype=kv_dtype)
    return Engine(model, params, cfg)


def request(prompt, max_new: int):
    from repro_torch.serve import ServeRequest
    return ServeRequest(prompt=prompt, max_new_tokens=max_new)


def warm_prefill(model, params, rows: int, length: int, page: int) -> None:
    """One prefill of ``rows`` prompts of ``length`` tokens on a scratch
    pool of its own, to read the peak memory of the cell's largest
    prefill before the pool is sized."""
    pages = -(-length // page)
    kv = model.init_kv_state(rows, rows * pages + 1, page, pages)
    table = torch.arange(rows * pages, dtype=torch.int32,
                         device=model.device).view(rows, pages)
    kv = kv._replace(page_table=table)
    tokens = torch.zeros((rows, pages * page), dtype=torch.int32,
                         device=model.device)
    lens = torch.full((rows,), length, dtype=torch.int32, device=model.device)
    model.prefill(params, tokens, lens, kv)
    if model.device.type == "cuda":
        torch.cuda.synchronize()

"""A tiny configuration and mixes for the CPU tests: the serve loops end
to end on the port's plain versions, at a size a test run holds."""

import importlib.util

import torch

from portbench.lib import spec

DENSE = dict(name="tiny-dense", family="dense", reference="dense",
             hidden_size=64, intermediate_size=96, num_attention_heads=4,
             num_hidden_layers=2, num_key_value_heads=2, head_dim=16,
             rms_norm_eps=1e-6, rope_theta=10000.0, torch_dtype="bfloat16",
             vocab_size=128, qkv_bias=True,
             serve=dict(page_size=16, max_batch=4, max_horizon=8,
                        prefix_cache=True),
             pool=dict(memory_fraction=0.9, warm_rows=2))
#: a light load, so that a slow or shared CPU still drains every request
OPEN = dict(kind="open", rate_rps=6.0, lead_in_s=0.3, drain_s=120,
            schedule_seed=0,
            prompt=dict(dist="lognormal", median=24, sigma=0.7, min=8,
                        max=64),
            output=dict(dist="lognormal", median=8, sigma=0.7, min=4,
                        max=12),
            prefixes=dict(count=3, min=20, max=40, zipf_s=1.0),
            warmup=[[64, 4], [24, 4], [8, 4], [40, 4]], trace_slice_s=0.5,
            check=dict(tokens=40, requests=4))


#: the tiny configuration's own limits, set from its readings on the CPU
#: (seeds 1-6): widest gap 0-0.015 and mean gap under 0.0003 against its
#: float8 control's 0.23-0.64 and 0.025-0.038
LIMITS = {"tiny-dense": {"widest_gap": 0.1, "mean_gap": 0.005}}


def ctx(conf, mix, cell, seed=3, seconds=1.0, **kw):
    """A run context on the CPU, held to the tiny configuration's limits;
    ``cell`` names the cell whose shape it stands in for."""
    s = importlib.util.spec_from_file_location("pb_run_t",
                                               spec.PKG / "run.py")
    run = importlib.util.module_from_spec(s)
    s.loader.exec_module(run)
    c = run.Ctx(seed=seed, seconds=seconds, trace=False,
                bench=spec.benchmark(), cell=dict(name=cell, chips=1),
                conf=conf, dims=spec.dims(conf), mix=mix,
                device=torch.device("cpu"), frames=64,
                limits=LIMITS[conf["name"]])
    c.__dict__.update(kw)
    return c

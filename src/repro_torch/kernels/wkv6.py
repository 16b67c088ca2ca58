"""RWKV-6 time-mix recurrence, one step at a time (``csrc/wkv6.cu``).

Per head of size N: ``o_t = r_t^T (diag(u) k_t v_t^T + S)``, then
``S = diag(w_t) S + k_t v_t^T``.  The CUDA kernel runs one block per
``(b, h)`` head and one thread per value column, each holding its column of
the ``[N, N]`` state in registers across the whole sequence; the loop over
T runs inside the block, so any T >= 1 is taken (no padding to a time
block).

Replaces the TPU kernel ``wkv6`` of ``src/repro/kernels/wkv6.py``.  The
model's serve path gives it f32 ``r, k, v, w [BH, T, N]``, ``u [BH, N]``
and an f32 state ``[BH, N, N]``; the output is in r's dtype (f32), the
final state f32.  ``out_state`` receives the final state in place (it may
be ``initial_state`` itself, or a slice of the caller's state tensor);
without it a new tensor is returned.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

#: head sizes the sequential kernel is compiled for
HEAD_SIZES = (8, 16, 32, 64)


def check_wkv6(r, k, v, w, u, initial_state=None, out_state=None, *,
               head_sizes=HEAD_SIZES) -> None:
    """Raise on anything the WKV kernels do not take: f32 contiguous
    ``[BH, T, N]`` operands with T >= 1, ``u [BH, N]``, ``[BH, N, N]``
    states, one device."""
    if r.dim() != 3:
        raise ValueError(f"r [BH, T, N] expected, got {tuple(r.shape)}")
    bh, t, n = r.shape
    if t < 1 or bh < 1:
        raise ValueError(f"empty input {tuple(r.shape)}")
    if n not in head_sizes:
        raise ValueError(f"head size {n} not in {head_sizes}")
    for name, x in (("k", k), ("v", v), ("w", w)):
        if tuple(x.shape) != (bh, t, n):
            raise ValueError(f"{name} {tuple(x.shape)} != r {(bh, t, n)}")
    if tuple(u.shape) != (bh, n):
        raise ValueError(f"u [BH, N] = {(bh, n)} expected, got "
                         f"{tuple(u.shape)}")
    states = [s for s in (initial_state, out_state) if s is not None]
    for s in states:
        if tuple(s.shape) != (bh, n, n):
            raise ValueError(f"state [BH, N, N] = {(bh, n, n)} expected, got "
                             f"{tuple(s.shape)}")
    ops = (r, k, v, w, u, *states)
    if any(x.dtype != torch.float32 for x in ops):
        raise TypeError("r, k, v, w, u and the states must be float32, got "
                        f"{[x.dtype for x in ops]}")
    if not all(x.is_contiguous() for x in ops):
        raise ValueError("r, k, v, w, u and the states must be contiguous")
    devs = {x.device for x in ops}
    if len(devs) != 1:
        raise ValueError(f"all operands must share one device, got {devs}")


def launch(name: str, r, k, v, w, u, initial_state, out_state):
    """Allocate the outputs and launch the C function ``name`` of
    :data:`build.SIGNATURES` (both WKV kernels share the signature)."""
    if r.device.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel: tensors must be on "
                         "a CUDA device")
    bh, t, n = r.shape
    o = torch.empty_like(r)
    s_out = out_state if out_state is not None else torch.empty(
        (bh, n, n), dtype=torch.float32, device=r.device)
    s0 = initial_state.data_ptr() if initial_state is not None else None
    err = build.launcher(name)(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0, o.data_ptr(), s_out.data_ptr(), bh, t, n,
        torch.cuda.current_stream(r.device).cuda_stream)
    build.check(err, name)
    return o, s_out


def wkv6(r, k, v, w, u, initial_state=None, *, out_state=None):
    """Launch the sequential CUDA kernel.  Returns (o [BH, T, N], final
    state [BH, N, N]).  CUDA tensors only."""
    check_wkv6(r, k, v, w, u, initial_state, out_state)
    out = launch("wkv6", r, k, v, w, u, initial_state, out_state)
    wkv6.launches += 1
    return out


wkv6.launches = 0

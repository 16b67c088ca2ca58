"""RWKV-6 time-mix recurrence, one step at a time (``csrc/wkv6.cu``).

Per head of size N: ``o_t = r_t^T (diag(u) k_t v_t^T + S)``, then
``S = diag(w_t) S + k_t v_t^T``.  The CUDA kernel runs one block per
``(b, h)`` head; each thread keeps an 8 x 8 tile of the ``[N, N]`` f32
state (8 channels x 8 value columns) in registers for the whole
sequence: 64 threads a head at N = 64, four blocks a SM, so
the serve path's 512 heads run in one wave.  A state entry never leaves
its thread; only ``o_j`` is a sum over channels, taken by shuffles among
the 8 lanes of a column tile, with the bonus folded in as ``v_j sum_i r_i
u_i k_i``.  The next 16 steps of r, k, w, v are staged by bulk copies while
the current 16 compute.  The loop over T runs inside the block, so any
T >= 1 is taken (no padding to a time block).  The work is bound by bytes
(352 MB at r [512, 512, 64] with a state, 105 us at 3.35 TB/s) with the f32
pipe close behind (three instructions per state entry and step, 96 us at
1.98 GHz); what binds in practice is instruction issue (see the source).

Replaces the TPU kernel ``wkv6`` of ``src/repro/kernels/wkv6.py``.  The
model's serve path gives it f32 ``r, k, v, w [BH, T, N]``, ``u [BH, N]``
and an f32 state ``[BH, N, N]``; the output is in r's dtype (f32), the
final state f32.  ``out_state`` receives the final state in place (it may
be ``initial_state`` itself, or a slice of the caller's state tensor);
without it a new tensor is returned.  On the card r, k, v, w and the states
must be 16-byte aligned (the kernel copies 16 bytes at a time).
"""

from __future__ import annotations

import ctypes

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
    bad = [key for key, x in (("r", r), ("k", k), ("v", v), ("w", w),
                              ("initial_state", initial_state),
                              ("out_state", out_state))
           if x is not None and x.data_ptr() % 16]
    if bad:
        raise ValueError(f"{name} copies 16 bytes at a time: {bad} not "
                         "16-byte aligned")
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


def launch_config(n: int, entry: str = "wkv6_config") -> dict[str, int]:
    """A WKV kernel's launch shape at head size ``n`` on the current card,
    from its C entry ``entry`` (:data:`build.SIGNATURES`): threads a block
    (one block a head), dynamic shared memory and the blocks resident on
    one SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).  Needs the
    card and ``nvcc``."""
    out = (ctypes.c_int * 3)()
    build.check(build.launcher(entry)(n, out), entry)
    return dict(threads=out[0], smem_bytes=out[1], blocks_per_sm=out[2])

"""Chunk-parallel RWKV-6 (flash-linear-attention form, ``csrc/
wkv6_chunked.cu``), chunks of 32 tokens.

The CUDA kernel runs one block per ``(b, h)`` head and loops over the
chunks; the ``[N, N]`` f32 state, the chunk's r/k/v, the cumulative log
decays and the ``[32, 32]`` masked attention stay in shared memory, so
device memory sees only the r/k/v/w/o streams and the state once.  Every
exponent is <= 0 (the mask is applied before the exp), so a decay of 1e-6
underflows instead of overflowing.  A ragged last chunk is padded in shared
memory with identity steps (w = 1, k = 0), so any T >= 1 is taken, though
the model's dispatch sends it only ``T % 32 == 0``.

Replaces the TPU kernel ``wkv6_chunked`` of
``src/repro/kernels/wkv6_chunked.py``.  Operands, outputs and
``out_state`` as in :mod:`repro_torch.kernels.wkv6`.
"""

from __future__ import annotations

from repro_torch.kernels.wkv6 import check_wkv6, launch

#: the chunk length (JAX ``ops.wkv6`` dispatches the Pallas kernel with 32)
CHUNK = 32
#: head sizes the chunked kernel takes (the state must fit shared memory)
HEAD_SIZES = tuple(range(1, 65))


def check_wkv6_chunked(r, k, v, w, u, initial_state=None,
                       out_state=None) -> None:
    """Raise on anything the chunked kernel does not take."""
    check_wkv6(r, k, v, w, u, initial_state, out_state,
               head_sizes=HEAD_SIZES)


def wkv6_chunked(r, k, v, w, u, initial_state=None, *, out_state=None):
    """Launch the chunked CUDA kernel.  Returns (o [BH, T, N], final state
    [BH, N, N]).  CUDA tensors only."""
    check_wkv6_chunked(r, k, v, w, u, initial_state, out_state)
    out = launch("wkv6_chunked", r, k, v, w, u, initial_state, out_state)
    wkv6_chunked.launches += 1
    return out


wkv6_chunked.launches = 0

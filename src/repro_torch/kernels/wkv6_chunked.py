"""Chunk-parallel RWKV-6 (flash-linear-attention form, ``csrc/
wkv6_chunked.cu``), chunks of 32 tokens, exact f32 on the CUDA cores.

The CUDA kernel runs one block per ``(b, h)`` head; each thread keeps a
4 x 4 tile of the ``[N, N]`` f32 state (channels x value columns, at
N = 64) in registers for the whole sequence.  Each chunk is cut into four
sub-blocks of 8 rows, and the decay between two sub-blocks factors as
``exp(ce_i - b_I) * exp(b_I - cum_j)``: the off-diagonal blocks of the
masked attention are plain f32 products with no exp inside, and only the
diagonal sub-blocks keep the mask-before-exp form.  Every exponent is a
non-positive difference of cumulative log decays, so a decay of 1e-6
underflows instead of overflowing.  The inter-chunk product, the
intra-chunk ``A v`` and the state update are register-tiled, and the next
chunk's r, k, w, v are staged by ``cp.async`` while the current one
computes.  A ragged last chunk is zero-filled with identity steps (w = 1,
k = 0), so any T >= 1 is taken, though the model's dispatch sends it only
``T % 32 == 0``.

Replaces the TPU kernel ``wkv6_chunked`` of
``src/repro/kernels/wkv6_chunked.py``.  Operands, outputs and
``out_state`` as in :mod:`repro_torch.kernels.wkv6`, whose shared launch
refuses r, k, v, w or states on the card that are not 16-byte aligned.
"""

from __future__ import annotations

from repro_torch.kernels.wkv6 import check_wkv6, launch
from repro_torch.kernels.wkv6 import launch_config as _launch_config

#: the chunk length (JAX ``ops.wkv6`` dispatches the Pallas kernel with 32)
CHUNK = 32
#: head sizes the chunked kernel is compiled for (those of ``wkv6``)
HEAD_SIZES = (8, 16, 32, 64)


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


def launch_config(n: int) -> dict[str, int]:
    """The chunked kernel's launch shape at head size ``n`` on the current
    card (:func:`repro_torch.kernels.wkv6.launch_config`)."""
    return _launch_config(n, "wkv6_chunked_config")

"""Placements of the serving executor's state on a ('kv', 'hd') mesh.

Port of ``executor_state_shardings`` in ``src/repro/launch/specs.py``.
The rest of that module, the dry-run cases (``build_*_case``,
``train_state_specs``), is not ported yet: it comes with the dry-run.
"""

from __future__ import annotations

from repro_torch.kernels import ops


def executor_state_shardings(mesh, num_kv_heads: int, head_dim: int) -> dict:
    """DTensor placements of the :class:`repro_torch.serve.executor.Executor`'s
    persistent state on a ('kv', 'hd') mesh.

    ``"pool"``: the pools ``[L, P, page, Hkv, hd]`` split over (kv, hd) on
    dims 3 and 4, each axis degrading to ``Replicate()`` where its extent
    does not divide the dim; ``"replicated"``: the layout of the page table
    and of every scalar-plane operand and output (tokens, lengths, logits,
    the sampled block), which every rank reads whole.

    Built on ``ops.kv_layout`` / ``ops.placements``, which the sharded
    wrappers read too (through ``launch.mesh.kv_partition_axes``), so the
    executor's layout and the one each kernel dispatch checks cannot
    disagree.
    """
    return {
        "pool": ops.kv_layout(mesh, num_kv_heads, head_dim, 3, 4),
        "replicated": ops.placements(mesh, {}),
    }

"""Sequence-parallel trunk execution (``deco_tpu/parallel/sp_trunk.py``).

Every operation of a ``FlattenDiTBlock`` but attention is token-local
(RMSNorm, adaLN, SwiGLU, residuals, RoPE given each position's row), so
the trunk runs with its tokens split over the mesh's model axis: each rank
takes its N/S tokens and its rows of the RoPE tables and runs the model's
own blocks with ``attn_impl="ring"``
(:func:`~deco_tpu_torch.parallel.ring_attention.ring_attention_local`),
the one place where ranks talk. The sequence is then all-gathered, so what
follows the trunk (the pixel decoder) sees what the sequential trunk
gives, on every rank of the model group.

Gradients: the parameters are replicated over the model axis while the
tokens are split, so each rank's parameter gradient is its tokens' share;
the gather's backward hands each rank S times its chunk, and the exact
gradient is the mean over the model group (then over the data axis), the
mean DDP and FSDP2 take over the world. ``remat`` recomputes each block in
the backward (non-reentrant checkpointing), which re-runs its ring in the
same order on every rank.
"""

from __future__ import annotations

from deco_tpu_torch.models import layers
from deco_tpu_torch.parallel import mesh as mesh_lib
from deco_tpu_torch.parallel.ring_attention import gather_sequence, split_sequence


def _local(x, rope, mesh):
    group = mesh_lib.axis_group(mesh, mesh_lib.MODEL_AXIS)
    rope_loc = tuple(split_sequence(t, group, dim=0) for t in rope)
    return group, split_sequence(x, group), rope_loc


def _ring_block(mesh, block, *args):
    """``block(*args)`` with ring attention over ``mesh``; the mesh is set
    here, inside what a checkpoint recomputes, since the recompute runs in
    the backward, after the executor has returned."""
    with mesh_lib.use_mesh(mesh):
        return block(*args, "ring")


def sequence_parallel_trunk(blocks, x, c, rope, *, mesh=None, remat: bool = False,
                            policy: str = "full"):
    """The c2i trunk (``FlattenDiTBlock``s, the model's ``blocks``) with the
    sequence split over ``mesh``'s model axis (default the current mesh).

    x: (B, N, hidden) this rank's rows, whole along N (the model axis must
    divide N); c: (B, 1, hidden); rope: (cos, sin), each (N, head_dim / 2).
    Returns (B, N, hidden), as the sequential trunk gives it.
    """
    mesh = mesh_lib.current_mesh() if mesh is None else mesh
    group, x_loc, rope_loc = _local(x, rope, mesh)
    for block in blocks:
        x_loc = layers.run_checkpointed(_ring_block, mesh, block, x_loc, c, rope_loc, None,
                                        enabled=remat, policy=policy)
    return gather_sequence(x_loc, group)


def sequence_parallel_joint_trunk(blocks, x, y, c, rope, *, mesh=None, remat: bool = False,
                                  policy: str = "full"):
    """The t2i joint trunk (``JointDiTBlock``s) sequence-parallel: the image
    tokens x (B, N, hidden) are split and their keys ride the ring, the
    text tokens y (B, M, hidden) stay whole on every rank and seed each
    ring's accumulator (``extra_kv``); ``rope`` covers the image positions
    only. Returns (B, N, hidden)."""
    mesh = mesh_lib.current_mesh() if mesh is None else mesh
    group, x_loc, rope_loc = _local(x, rope, mesh)
    for block in blocks:
        x_loc = layers.run_checkpointed(_ring_block, mesh, block, x_loc, y, c, rope_loc,
                                        enabled=remat, policy=policy)
    return gather_sequence(x_loc, group)

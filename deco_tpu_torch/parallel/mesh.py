"""The (data, model) mesh and what the loops do with it
(``deco_tpu/parallel/mesh.py``).

JAX's ``Mesh`` spans the devices of one controller; the port's is a
``torch.distributed.device_mesh.DeviceMesh`` over the processes of the
default group (one per GPU), with the dimension names :data:`DATA_AXIS`
and :data:`MODEL_AXIS`. A single process without a group has no mesh:
:func:`make_mesh` gives None there, and every helper here reads None as
the 1 x 1 grid.

- :func:`make_mesh`: ``data=None`` takes the whole world; a model axis
  that does not divide it raises, as in JAX.
- The current mesh: the loops set it (:func:`use_mesh`, JAX's
  ``jax.set_mesh``) and the trunk executors read it
  (:func:`current_mesh`, JAX's ``ambient_mesh``), so nothing rides on a
  module's attributes.
- :func:`batch_rows`: the rows of a global batch this process holds (in
  place of ``shard_batch``): rank ``d`` of the data axis takes rows
  ``d*b ... (d+1)*b - 1`` of each microbatch of the global batch that one
  process over the whole world would load, so a fit on W ranks computes
  the world-1 fit of the same global batch.
- :class:`RowDraws`: a step's random draws made for the global batch from
  one generator and cut to this rank's rows.
- :func:`param_partition_spec` and :func:`shard_params`: fsdp as FSDP2's
  ``fully_shard`` over the 2-D mesh, replicated over ``data`` and sharded
  over ``model``, one unit a block; a parameter of at least ``min_size``
  elements shards its largest dimension that the model axis divides, every
  other parameter its first (FSDP2 has no replicated parameter inside a
  sharded module).
- Gradient bookkeeping for DTensor (sharded) gradients: :func:`local`,
  :func:`grad_norm`, and :func:`mean_over_world` for the steps that take
  ``torch.autograd.grad`` (no DDP hook sees those).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from deco_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"

_CURRENT: list = [None]


def make_mesh(data: Optional[int] = None, model: int = 1):
    """A (data, model) ``DeviceMesh`` over the default group's processes
    (on the cards under NCCL, else on the CPU), or None for a single
    process without a group (the 1 x 1 grid). ``data=None`` puts every
    process the model axis leaves on the data axis."""
    world = distributed.world_size()
    model = int(model)
    if model < 1 or world % model:
        raise ValueError(f"{world} processes not divisible by model={model}")
    if data is None:
        data = world // model
    if int(data) * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} processes")
    if not distributed.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (int(data), model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group along ``axis`` (None for the 1 x 1 grid)."""
    return None if mesh is None else mesh.get_group(axis)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the current mesh inside (``jax.set_mesh``)."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh():
    """The innermost :func:`use_mesh` mesh (None: the 1 x 1 grid)."""
    return _CURRENT[-1]


def rank_rows(index: int, count: int, batch: int, microbatches: int = 1) -> np.ndarray:
    """The indices, in the global batch of ``batch * count`` rows, of the
    ``batch`` rows data rank ``index`` of ``count`` holds: with
    ``microbatches`` k, rows ``i*m*count + index*m ... i*m*count +
    (index+1)*m - 1`` of each microbatch i, m = batch / k. One rank holds
    ``arange(batch)``."""
    if batch % microbatches:
        raise ValueError(f"batch {batch} does not split into {microbatches} microbatches")
    m = batch // microbatches
    return np.concatenate([i * m * count + index * m + np.arange(m)
                           for i in range(microbatches)])


def batch_rows(mesh, batch: int, microbatches: int = 1) -> np.ndarray:
    """:func:`rank_rows` of this process's data rank."""
    return rank_rows(axis_index(mesh, DATA_AXIS), axis_size(mesh, DATA_AXIS), batch,
                     microbatches)


class RowDraws:
    """Random draws for the global batch, cut to this process's rows.

    ``generator`` is the step's, seeded alike on every rank. A draw of
    local shape (B, ...) is made at the global shape (``global_rows``, ...),
    as one process over the whole world would draw it, and ``rows`` (B
    indices into the global rows) picks this rank's part. The objectives
    draw through :func:`sample` and :func:`sample_int`, which take a plain
    generator too. So each rank's random-number work and temporary memory
    grow with the data axis: a 256 x 256 x 3 fp32 noise draw at 32 rows a
    rank on 8 data ranks is ~200 MB a draw (neither the CPU's Mersenne
    Twister nor CUDA's Philox fill gives a row the same values when fewer
    rows are drawn).
    """

    def __init__(self, generator: torch.Generator, rows, global_rows: int):
        self.generator = generator
        self.rows = torch.as_tensor(np.asarray(rows), dtype=torch.long)
        self.global_rows = int(global_rows)

    def draw(self, fn, shape, device, high: Optional[int] = None) -> torch.Tensor:
        shape = tuple(shape)
        if not shape or shape[0] != len(self.rows):
            raise ValueError(f"draw of shape {shape} does not lead with this rank's "
                             f"{len(self.rows)} rows")
        whole = (self.global_rows,) + shape[1:]
        if fn is torch.randint:
            out = torch.randint(0, high, whole, generator=self.generator, device=device)
        else:
            out = fn(whole, generator=self.generator, device=device)
        return out.index_select(0, self.rows.to(out.device))


def microbatch_draws(generator, mesh, local_rows: int, repeats: int = 1):
    """The generator of one microbatch: ``generator`` itself on one data
    rank, else a :class:`RowDraws` whose rows are this rank's part of each
    of the ``repeats`` copies (``diffusion_batch_mul``) of the global
    microbatch."""
    n = axis_size(mesh, DATA_AXIS)
    if n == 1 or generator is None:
        return generator
    m = local_rows // repeats
    own = batch_rows(mesh, m)
    rows = np.concatenate([j * m * n + own for j in range(repeats)])
    return RowDraws(generator, rows, local_rows * n)


def sample(generator, shape, device, normal: bool = True) -> torch.Tensor:
    """``torch.randn``/``torch.rand`` of ``shape`` from ``generator`` (a
    ``torch.Generator`` or a :class:`RowDraws`)."""
    fn = torch.randn if normal else torch.rand
    if isinstance(generator, RowDraws):
        return generator.draw(fn, shape, device)
    return fn(tuple(shape), generator=generator, device=device)


def sample_int(generator, high: int, shape, device) -> torch.Tensor:
    """``torch.randint(0, high, shape)`` from ``generator`` (plain or :class:`RowDraws`)."""
    if isinstance(generator, RowDraws):
        return generator.draw(torch.randint, shape, device, high=high)
    return torch.randint(0, high, tuple(shape), generator=generator, device=device)


def param_partition_spec(shape: Sequence[int], *, model_axis_size: int,
                         min_size: int = 2**20) -> Optional[int]:
    """The dimension fsdp shards a parameter of ``shape`` along, or None
    (replicated): None below ``min_size`` elements or with one model rank,
    else the largest dimension the model axis divides (the first of equal
    ones), None when none does (``param_partition_spec``)."""
    shape = tuple(shape)
    if model_axis_size <= 1 or int(np.prod(shape)) < min_size:
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % model_axis_size == 0:
            return i
    return None


def shard_params(module: torch.nn.Module, mesh, min_size: int = 2**20,
                 whole: Sequence[torch.nn.Module] = ()) -> torch.nn.Module:
    """fsdp: FSDP2 ``fully_shard`` over the 2-D ``mesh`` (HSDP: replicated
    over ``data``, sharded over ``model``), each large parameter along
    :func:`param_partition_spec`'s dimension and every other along its
    first. Each block (every element of an ``nn.ModuleList`` in ``module``:
    the trunk's and the pixel decoder's) is a unit of its own, gathered
    for its forward and its backward only, as JAX gathers a weight where it
    is used; the rest is the root's unit, gathered for the whole step. The
    lists in ``whole`` stay in the root's unit: the tensor-parallel trunk
    reads its blocks' parameters without calling the blocks. In place;
    returns the module."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    m = axis_size(mesh, MODEL_AXIS)

    def placement(param):
        dim = param_partition_spec(param.shape, model_axis_size=m, min_size=min_size)
        return Shard(0 if dim is None else dim)

    skip = {id(w) for w in whole}
    for lst in [x for x in module.modules() if isinstance(x, torch.nn.ModuleList)]:
        if id(lst) not in skip:
            for block in lst:
                fully_shard(block, mesh=mesh, shard_placement_fn=placement)
    fully_shard(module, mesh=mesh, shard_placement_fn=placement)
    return module


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, any other tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (a collective: every rank calls it), any
    other tensor itself."""
    return t.full_tensor() if is_dtensor(t) else t


def like(param: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``value`` (a whole tensor) laid out as ``param``: this rank's shard of
    it for a DTensor parameter (sliced locally, no communication), else
    itself on the parameter's device."""
    if not is_dtensor(param):
        return value.to(param.device)
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(value.to(param.to_local().device), param.device_mesh,
                             param.placements, src_data_rank=None)


def grad_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of ``grads`` (``optax.global_norm``), DTensor
    shards included: their squares summed over the mesh dimensions they are
    sharded on."""
    plain = [g for g in grads if not is_dtensor(g)]
    sharded = [g for g in grads if is_dtensor(g)]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(plain))) if plain else None
    if not sharded:
        return norm
    sq = torch.stack([g.to_local().float().pow(2).sum() for g in sharded]).sum()
    mesh = sharded[0].device_mesh
    for i, p in enumerate(sharded[0].placements):
        if p.is_shard():
            dist.all_reduce(sq, group=mesh.get_group(i))
    return sq.sqrt() if norm is None else torch.sqrt(sq + norm.float() ** 2)


def mean_over_world(tensors: Sequence[torch.Tensor]) -> None:
    """In place: each tensor replaced by its mean over every process (one
    all-reduce of the flattened list). A no-op in a single process."""
    if not distributed.is_initialized() or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def gather_data_rows(mesh, rows: np.ndarray) -> np.ndarray:
    """A host batch of every data rank's rows, concatenated in data-rank
    order (the global batch); every process calls it. One process gives
    ``rows``."""
    if mesh is None:
        return rows
    parts = distributed.process_allgather(rows)
    return np.concatenate(list(parts[::axis_size(mesh, MODEL_AXIS)]), axis=0)


def global_value(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a per-rank mean) carrying the mean over every process as its
    value and its own gradient: a term that is not linear in a batch mean
    (LeCam's) then gets, after the gradients' mean over the world, the
    gradient of the global-batch term."""
    if not distributed.is_initialized():
        return x
    g = x.detach().clone()
    dist.all_reduce(g)
    g /= dist.get_world_size()
    return x + (g - x.detach())

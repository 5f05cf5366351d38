"""Process groups and the lane sharding of multi-process training.

Port of ``safelife_tpu/parallel/mesh.py`` onto ``torch.distributed``, one
process a rank (``torchrun --nproc-per-node N -m safelife_tpu_torch
train ...``). A run over R ranks with global batch B is one program: rank
r holds the global lanes ``[r B/R, (r+1) B/R)`` of the env batch, and its
results equal the one-process run with batch B (integer state bit for
bit, the learner to float32 rounding). Every rank starts from the same
full state and draws every random number at the global shape from a
generator seeded alike on every rank, then keeps its own lanes
(:func:`draw_global`); the kernels K1 and K2 draw their spawn coins at
the global lane (``lane_offset``). The learner is replicated: gradients
are summed over the ranks (:func:`allreduce_grads`), so every rank takes
the same Adam step. The level pool is the concatenation of every rank's
own level stream (:func:`allgather_level_pool`).

The JAX functions and their counterparts:

* ``initialize_distributed`` -> :func:`initialize_distributed` (a
  ``torch.distributed`` process group instead of JAX's coordinator);
* ``per_host_seed`` -> :func:`per_host_seed`, bit for bit; ``is_logging_host``
  -> :func:`is_logging_host`; ``jax.process_index``/``process_count`` ->
  :func:`process_index`/:func:`process_count`;
* ``training_mesh`` -> :func:`training_group`: None in one process;
* ``batch_sharding``, ``shard_env_state`` and ``global_batch`` ->
  :func:`lane_range`: which global lanes a rank holds. A rank's tensors
  hold only its lanes; there is no global array to place;
* the gradient ``psum`` XLA inserts -> :func:`allreduce_grads`;
* ``allgather_level_pool`` -> :func:`allgather_level_pool` (static flags
  ANDed); ``gather_episodes`` -> :func:`gather_episodes`.

``make_mesh``, ``batch_sharding``, ``replicated_sharding``, ``replicate``,
``global_replicated`` and ``addressable_values`` have no counterpart: a
process group has no device mesh or sharding annotations, a rank's
tensors are its shard, and every rank builds the same state from the
same seed.

Every collective runs over the default process group. Without one
(:func:`training_group` None) each is the identity: a reduction or a
gather over one rank. So the learner, the replay push and the level
pool manager run one path, in one process and over R ranks.

Backends: ``nccl`` for a CUDA device, ``gloo`` for the CPU, unless the
caller names one. ``gloo`` also takes CUDA tensors for the all-reduce,
all-gather and broadcast used here (it copies them through the host
itself; checked on an H100 with torch 2.11), so two ranks can share one
card over ``gloo``.
"""

import dataclasses
import datetime
import os
import typing

import numpy as np
import torch
import torch.distributed as dist

def initialize_distributed(backend=None, rank=None, world_size=None,
                           init_method=None, device="cuda", timeout=None):
    """Join the process group of a multi-process run.

    Explicit arguments win; otherwise ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) is read. With no world
    size configured anywhere this is a no-op (one process), as JAX's is; a
    configured group that fails to start raises. The backend is ``nccl``
    for a CUDA ``device`` and ``gloo`` for the CPU unless ``backend`` names
    one; ``timeout`` (seconds) bounds the start and every collective.

    Returns (rank, world_size).
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if world_size is None:
        return 0, 1
    if rank is None:
        raise ValueError("a world size of %d is configured but no rank"
                         % world_size)
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    if backend == "nccl" and device.index is not None:
        kwargs["device_id"] = device  # the rank's card, bound at the start
    dist.init_process_group(backend=backend,
                            init_method=init_method or "env://",
                            rank=rank, world_size=world_size, **kwargs)
    return dist.get_rank(), dist.get_world_size()


def process_index():
    return dist.get_rank() if dist.is_initialized() else 0


def process_count():
    return dist.get_world_size() if dist.is_initialized() else 1


def is_logging_host():
    """Only rank 0 writes logs, checkpoints and evaluations."""
    return process_index() == 0


def per_host_seed(seed, process_index=None):
    """The level-stream seed of rank ``process_index``: the rank folded into
    the ``SeedSequence``'s spawn key, as JAX's ``per_host_seed`` folds the
    host id (streams differ across ranks and do not depend on the world
    size)."""
    if process_index is None:
        process_index = dist.get_rank() if dist.is_initialized() else 0
    root = seed if isinstance(seed, np.random.SeedSequence) \
        else np.random.SeedSequence(seed)
    return np.random.SeedSequence(
        entropy=root.entropy,
        spawn_key=root.spawn_key + (np.uint32(process_index),))


def training_group():
    """The process group of a multi-process run (the default group), or
    None in one process, where every collective here is the identity."""
    if process_count() == 1:
        return None
    return dist.group.WORLD


class LaneRange(typing.NamedTuple):
    """The global lanes ``[start, stop)`` of a batch of ``total`` that one
    rank holds. ``start`` is the rank's ``lane_offset``."""

    start: int
    stop: int
    total: int

    @property
    def size(self):
        return self.stop - self.start


def lane_range(batch, rank=None, world=None):
    """The lanes rank ``rank`` of ``world`` holds of a global batch of
    ``batch``: contiguous and equal; raises unless ``batch`` divides
    evenly."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    if batch % world:
        raise ValueError("global batch_size %d must divide over %d global "
                         "devices" % (batch, world))
    n = batch // world
    return LaneRange(rank * n, (rank + 1) * n, batch)


def draw_global(draw, local_shape, lanes):
    """``draw(shape)`` at the global shape, cut to the rank's rows: the
    leading axis of ``local_shape`` holds ``k`` rows a lane (``k`` agents,
    say), and the global draw has ``k * lanes.total`` rows, of which the
    rank keeps those of its lanes. With ``lanes`` None, ``draw`` runs at
    ``local_shape``. Every rank draws from an equally seeded generator, so
    each keeps what a one-process draw gives its lanes."""
    local_shape = tuple(local_shape)
    if lanes is None:
        return draw(local_shape)
    k = local_shape[0] // lanes.size
    out = draw((k * lanes.total,) + local_shape[1:])
    return out[k * lanes.start:k * lanes.stop]


# ---------------------------------------------------------------------------
# Collectives


def all_gather(tensor):
    """Every rank's ``tensor`` (equal shapes), in rank order, on
    ``tensor``'s device; ``[tensor]`` without a process group."""
    if training_group() is None:
        return [tensor]
    src = tensor.contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(out, src)
    return out


def all_gather_object(obj):
    """Every rank's ``obj`` (anything picklable), in rank order; ``[obj]``
    without a process group."""
    if training_group() is None:
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def all_reduce_sum(tensor):
    """The sum over the ranks of ``tensor``, outside the autograd graph:
    a new tensor on its device, or ``tensor.detach()`` without a process
    group."""
    if training_group() is None:
        return tensor.detach()
    out = tensor.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def barrier():
    """Wait for every rank; nothing without a process group."""
    if training_group() is not None:
        dist.barrier()


def sync_generator(generator, src=0):
    """Give every rank rank ``src``'s state of ``generator``: after work
    that only rank 0 draws for (its evaluations), every rank goes on from
    the state a one-process run would have."""
    if training_group() is None:
        return generator
    box = [generator.get_state() if process_index() == src else None]
    dist.broadcast_object_list(box, src=src)
    generator.set_state(box[0])
    return generator


def _grad_bucket(model):
    """(parameters, one flat tensor of their gradients); a parameter
    without a gradient counts as zero."""
    params = [p for p in model.parameters() if p.requires_grad]
    return params, torch.cat([(p.grad if p.grad is not None
                               else torch.zeros_like(p)).reshape(-1)
                              for p in params])


def _set_grads(params, flat):
    off = 0
    for p in params:
        g = flat[off:off + p.numel()].view_as(p)
        if p.grad is None:
            p.grad = g.clone()
        else:
            p.grad.copy_(g)
        off += p.numel()


def allreduce_grads(model):
    """Sum every parameter's gradient over the ranks, in place: one flat
    float32 bucket, one all-reduce. Returns ``model``, untouched without a
    process group."""
    if training_group() is None:
        return model
    params, flat = _grad_bucket(model)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    _set_grads(params, flat)
    return model


def broadcast_grads(model, src=0):
    """Rank ``src``'s gradients on every rank, in place (one flat bucket):
    ranks that computed the same gradients keep bitwise equal ones even
    where a library's kernels do not sum in a fixed order. Returns
    ``model``, untouched without a process group."""
    if training_group() is None:
        return model
    params, flat = _grad_bucket(model)
    dist.broadcast(flat, src=src)
    _set_grads(params, flat)
    return model


_POOL_FLAGS = ("all_goals_static", "spawner_free")


def allgather_level_pool(pool):
    """Every rank's level pool (equal shapes: the ranks agree on their
    padding first) concatenated along the level axis, in rank order: the
    same replicated pool on every rank. The static flags are ANDed.
    ``pool`` itself without a process group."""
    if training_group() is None:
        return pool
    fields = {}
    for f in dataclasses.fields(pool):
        if f.name in _POOL_FLAGS:
            continue
        fields[f.name] = torch.cat(all_gather(getattr(pool, f.name)))
    flags = torch.tensor([int(getattr(pool, k)) for k in _POOL_FLAGS],
                         dtype=torch.int32, device=pool.board.device)
    agreed = torch.stack(all_gather(flags)).all(0).tolist()
    return type(pool)(**fields, **dict(zip(_POOL_FLAGS, map(bool, agreed))))


def gather_episodes(tree, axis=0):
    """Every rank's tensors of ``tree`` (episode records, or any tensor,
    dataclass or dict of them, nested) concatenated along ``axis`` in rank
    order, on every rank: with ``axis`` the lane axis, the global batch's.
    ``tree`` itself without a process group."""
    if training_group() is None:
        return tree
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: gather_episodes(getattr(tree, f.name), axis)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: gather_episodes(v, axis) for k, v in tree.items()}
    return torch.cat(all_gather(tree), axis)

"""Data parallelism over several devices: one process a rank.

Counterpart of ``rvc_tpu/parallel/mesh.py:21-45``. The JAX package runs one
process over a ``('dp',)`` mesh, shards each batch's rows over it
(``NamedSharding(P('dp'))``), replicates the state, and lets XLA insert the
gradient all-reduce. The port runs the reference's layout instead (one
process per GPU, training_cli.py:104-121): ``torch.distributed``, NCCL
between cards and gloo between CPU processes. The names stay JAX's:

- ``World``: this process's rank, the world size, its device and group,
  and the collectives the training step needs: a sum whose backward passes
  the cotangent through unchanged (``sum``, ``mean``), the extremes of a
  tensor over every rank's rows through a differentiable gather
  (``extrema``), one flat all-reduce of a model's gradients
  (``sum_grads``);
- ``init_world``: joins the group (NCCL for ``cuda``, gloo for ``cpu``;
  ``backend`` overrides, e.g. gloo for two ranks sharing one card);
- ``make_mesh``: the number of ranks, as the gcd with the batch size;
- ``shard_batch``: rank r's rows ``[r B / W, (r + 1) B / W)`` of every array;
- ``replicate``: rank 0's modules and training state broadcast to all;
- ``spawn``: one process a rank, each joined through a rendezvous file
  (never a fixed port), returning every rank's result;
- the 2-D ``(dp, tp)`` mesh (rvc_tpu/parallel/mesh.py:53-82):
  ``make_mesh_2d`` (a ``DeviceMesh`` named ``("dp", "tp")`` over the
  world's ranks), ``tp_param_spec`` (JAX's rule: a parameter's dim 0, its
  output channels, sharded over ``tp`` when it divides evenly and gives
  each rank at least two; replicated over ``dp``) and ``shard_params_tp``
  (each parameter of the modules a ``torch.distributed.tensor.DTensor``
  so placed); ``gather_tp`` gives parameters' whole values, gathered over
  tp; ``mesh_world`` is the ``World`` of a rank's ``dp`` group, over which
  ``Trainer(mesh=)`` reduces its losses and gradients.

Why the sums pass cotangents through unchanged: every rank computes the
losses from the same all-reduced values, so each rank's backward already
holds d loss / d (its own contribution). A differentiable all-reduce
(``torch.distributed.nn``) would sum those cotangents over the ranks and
make each gradient W times too large once the parameter gradients are
summed, which they must be (``Trainer.step`` differentiates with
``torch.autograd.grad``, which no ``DistributedDataParallel`` hook sees).
"""
from __future__ import annotations

import math
import os
import tempfile
import uuid
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = timedelta(minutes=5)  # a rank that never arrives ends the run


@dataclass
class World:
    rank: int
    size: int
    device: torch.device
    group: object = None  # None: the default group

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``x``; its backward is the identity."""
        return _Summed.apply(x, self)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over ranks: the global mean of equal-sized local means."""
        return self.sum(x) / self.size

    def extrema(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(min, max) of ``x`` over every rank's elements, as ``torch.amin``
        and ``torch.amax`` of the whole batch. The gather's backward sums the
        extreme's cotangent over the ranks (every rank's elements depend on
        it) into the rank that holds it; a tie is shared among the ranks that
        hold it, then among a rank's own elements. At world size 1 the values
        and gradients are amin's and amax's, bit for bit."""
        from torch.distributed.nn.functional import all_gather

        local = torch.stack([torch.amin(x), torch.amax(x)])
        every = torch.stack(all_gather(local, group=self.group))
        return torch.amin(every[:, 0]), torch.amax(every[:, 1])

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        if n % self.size:
            raise ValueError(f"a batch of {n} does not split over {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    @torch.no_grad()
    def sum_grads(self, grads: list) -> list:
        """Every rank's gradients summed, through one flat buffer a dtype;
        returns views of it in the order given."""
        return _flat_collective(grads, lambda flat: self.all_reduce_(flat))

    def barrier(self) -> None:
        dist.barrier(group=self.group)


class _Summed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world):
        return world.all_reduce_(x.detach().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _flat_collective(tensors: list, collective) -> list:
    """``collective`` run once a dtype over the tensors packed into one flat
    buffer; returns the results as views shaped as the inputs."""
    out = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        collective(flat)
        offset = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[offset:offset + n].view(tensors[i].shape)
            offset += n
    return out


def init_world(rank: int, world_size: int, device, rendezvous: str,
               backend: str | None = None) -> World:
    """Join the process group as ``rank`` of ``world_size`` on ``device``
    through ``rendezvous`` (an init method: ``file://...`` or
    ``tcp://localhost:port``). NCCL on a card, gloo on the CPU, unless
    ``backend`` says otherwise. A failure raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=rendezvous, rank=rank, world_size=world_size,
                            timeout=TIMEOUT)
    return World(rank, world_size, dev)


def make_mesh(n_dp: int | None, batch_size: int, device=None) -> int:
    """The number of ranks (rvc_tpu/pipelines/train.py:85-87): ``n_dp``, or
    every card when it is None (1 on the CPU), then its gcd with the batch
    size, so that the batch splits evenly. More ranks than cards raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        n = cards if n_dp is None else n_dp
        if n > cards:
            raise RuntimeError(f"{n} ranks asked for, {cards} card(s) present")
    else:
        n = 1 if n_dp is None else n_dp
    if n < 1:
        raise ValueError(f"n_devices must be at least 1, not {n}")
    return math.gcd(n, batch_size)


def rank_device(device, rank: int) -> torch.device:
    """Rank r's device: ``cuda:r`` on the cards, or the CPU."""
    dev = torch.device("cuda" if device is None else device)
    return torch.device("cuda", rank) if dev.type == "cuda" and dev.index is None else dev


def shard_batch(batch: dict, world: World) -> dict:
    """Rank ``world.rank``'s rows of every array of a ``BucketBatcher`` batch."""
    return {k: np.asarray(v)[world.rows(len(v))] for k, v in batch.items()}


@torch.no_grad()
def replicate(world: World, modules=(), state=None) -> None:
    """Rank 0's parameters and buffers of ``modules``, and of a training
    ``state`` its AdamW moments and balancer states, broadcast to every
    rank in place."""
    tensors = [t for m in modules for t in m.state_dict().values()]
    if state is not None:
        tensors += [*state.opt_g.m, *state.opt_g.v, *state.opt_d.m, *state.opt_d.v,
                    *state.balancer_g, *state.balancer_d]
    tensors = [t for t in tensors if t.is_floating_point()]
    flat = _flat_collective(tensors, lambda f: dist.broadcast(f, 0, group=world.group))
    for t, f in zip(tensors, flat):
        t.copy_(f)
    if state is not None:  # a count a rank resumed at must be everyone's
        counts = torch.tensor([state.opt_g.count, state.opt_d.count, state.step],
                              dtype=torch.float64, device=world.device)
        dist.broadcast(counts, 0, group=world.group)
        if counts.tolist() != [state.opt_g.count, state.opt_d.count, state.step]:
            raise RuntimeError("the ranks resumed from different steps")


def make_mesh_2d(n_dp: int, n_tp: int, device=None):
    """A ``DeviceMesh`` named ``("dp", "tp")`` over the ``n_dp * n_tp`` ranks
    of the process group (``init_world``'s, NCCL or gloo as it was joined):
    rank r at dp r // n_tp and tp r % n_tp, on the cards unless ``device``
    is "cpu" (without a card the default raises)."""
    from torch.distributed.device_mesh import init_device_mesh

    from ..device import resolve_device

    dev = resolve_device(device)
    if dist.get_world_size() != n_dp * n_tp:
        raise ValueError(f"a {n_dp} x {n_tp} mesh needs {n_dp * n_tp} ranks, the world has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(dev.type, (n_dp, n_tp), mesh_dim_names=("dp", "tp"))


def tp_param_spec(shape, n_tp: int) -> tuple:
    """The placements over ``("dp", "tp")`` of a parameter of ``shape`` in
    torch's layout (rvc_tpu/parallel/mesh.py:61-72): dim 0 (a conv's or a
    linear layer's output channels, a weight-norm gain's rows) sharded over
    tp when it divides by ``n_tp`` and is at least ``2 n_tp``, the tensor
    replicated otherwise; always replicated over dp."""
    from torch.distributed.tensor import Replicate, Shard

    shape = tuple(shape)
    if shape and shape[0] % n_tp == 0 and shape[0] >= 2 * n_tp:
        return (Replicate(), Shard(0))
    return (Replicate(), Replicate())


def tp_sharded(p) -> bool:
    """Whether a parameter is a ``DTensor`` sharded over tp."""
    from torch.distributed.tensor import DTensor

    return isinstance(p, DTensor) and p.placements[-1].is_shard()


@torch.no_grad()
def shard_params_tp(mesh, modules) -> None:
    """Every parameter of ``modules`` becomes a ``DTensor`` on ``mesh``,
    placed by ``tp_param_spec``, in place (the parameter order kept). Every
    rank holds the same weights (drawn from one seed, or loaded), so each
    keeps its own slice, with no communication."""
    from torch import nn
    from torch.distributed.tensor import distribute_tensor

    n_tp = mesh["tp"].size()
    for module in modules:
        for m in module.modules():
            for name, p in list(m._parameters.items()):
                if p is not None:
                    m._parameters[name] = nn.Parameter(
                        distribute_tensor(p.detach(), mesh, tp_param_spec(p.shape, n_tp),
                                          src_data_rank=None),
                        requires_grad=p.requires_grad)


class _GatherTp(torch.autograd.Function):
    """The whole values of tp-sharded tensors from this rank's slices: one
    ``all_gather_into_tensor`` over the tp group of the slices packed flat,
    each tensor's rank chunks stacked along dim 0. The backward keeps this
    rank's slice of each gradient, with no sum over tp: every tp rank of a
    dp group computes the same rows, so each already holds the whole
    gradient (a sum would make it ``n_tp`` times too large)."""

    @staticmethod
    def forward(ctx, group, index: int, n: int, *slices):
        flat = torch.cat([t.reshape(-1) for t in slices])
        gathered = flat.new_empty(n * flat.numel())
        dist.all_gather_into_tensor(gathered, flat, group=group)
        chunks = gathered.view(n, -1)
        wholes, offset = [], 0
        for t in slices:
            k = t.numel()
            wholes.append(chunks[:, offset:offset + k].reshape((n * t.shape[0],)
                                                               + tuple(t.shape[1:])))
            offset += k
        ctx.rows = [(index * t.shape[0], t.shape[0]) for t in slices]
        return tuple(wholes)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None, *[g[s:s + k] for g, (s, k) in zip(grads, ctx.rows)])


def gather_tp(params: list) -> list:
    """The whole values of ``shard_params_tp`` parameters (of one dtype, on
    one mesh), differentiable: each gradient comes back to its DTensor as
    this rank's slice (a replicated one's whole). ``DTensor.full_tensor()``
    computes the same a tensor at a time, but its functional all-gather
    crashes (SIGSEGV) on gloo with CUDA tensors (torch 2.11 on the card),
    where ``all_gather_into_tensor`` works; so the gather is that
    collective, once for all the sharded tensors, in an autograd function."""
    from torch.distributed.tensor import DTensor

    out = [p.to_local() if isinstance(p, DTensor) else p for p in params]
    sharded = [i for i, p in enumerate(params) if tp_sharded(p)]
    if sharded:
        m = params[sharded[0]].device_mesh
        wholes = _GatherTp.apply(m.get_group("tp"), m.get_local_rank("tp"), m["tp"].size(),
                                 *[out[i] for i in sharded])
        for i, w in zip(sharded, wholes):
            out[i] = w
    return out


@torch.no_grad()
def tp_mean(mesh, tensors: list) -> list:
    """The mean over this rank's tp group of each tensor, through one flat
    all-reduce a dtype."""
    n = mesh["tp"].size()
    summed = _flat_collective(tensors, lambda f: dist.all_reduce(f, group=mesh.get_group("tp")))
    return [t / n for t in summed]


def mesh_world(mesh, device) -> World:
    """The ``World`` of this rank's ``dp`` group on a ``make_mesh_2d`` mesh:
    the ranks that hold the other rows of the batch and the same slices of
    the weights."""
    return World(mesh.get_local_rank("dp"), mesh["dp"].size(), torch.device(device),
                 mesh.get_group("dp"))


def _entry(rank: int, fn, world_size: int, device, rendezvous: str, backend, threads: int,
           out_dir: str, args: tuple) -> None:
    torch.set_num_threads(threads)
    world = init_world(rank, world_size, rank_device(device, rank), rendezvous, backend)
    try:
        result = fn(world, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        world.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, device=None, args: tuple = (), backend: str | None = None,
          rendezvous_dir: str | None = None) -> list:
    """Run ``fn(world, *args)`` in ``world_size`` new processes (the spawn
    start method), rank r on ``rank_device(device, r)``, joined through a
    fresh rendezvous file under ``rendezvous_dir`` (a temporary directory
    when None). Returns each rank's return value (tensors, numbers,
    strings and containers of them), in rank order. A rank that raises, or
    dies, makes this raise once every process has ended. Each rank runs as
    many CPU threads as this process."""
    import torch.multiprocessing as mp

    threads = torch.get_num_threads()
    with tempfile.TemporaryDirectory(prefix="rvc_world_", dir=rendezvous_dir) as out_dir:
        rendezvous = "file://" + os.path.join(out_dir, f"rendezvous-{uuid.uuid4().hex}")
        mp.start_processes(_entry, args=(fn, world_size, device, rendezvous, backend, threads,
                                         out_dir, args),
                           nprocs=world_size, join=True, start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=True)
                for r in range(world_size)]

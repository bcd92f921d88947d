"""Data-parallel process groups over ``torch.distributed`` (counterpart of
``parallel/mesh.py``).

The reference is DD-PPO: one process per device, a TCPStore rendezvous and
NCCL all-reduces.  The JAX package maps that onto one SPMD program over a
device mesh; the port maps it back to torch's own idiom, one process per
rank:

- rendezvous            -> :func:`init_distributed` (a process started as
                           one of W ranks, under SLURM or ``torchrun``) or
                           :func:`spawn` (one host: the W ranks are started
                           here, ``spawn`` start method);
- ``pmean(grads)``      -> :meth:`Group.all_reduce_` (``"mean"``), one
                           flattened buffer a call;
- ``psum`` of (sum, sumsq, count) -> :meth:`Group.all_reduce_` (``"sum"``);
- host-side gathers     -> :meth:`Group.all_gather_object` over the CPU.

The mesh helpers have no counterpart: ``make_mesh`` is a :class:`Group`
(one process a device), ``replicate`` is :meth:`Group.broadcast_module`
(rank 0's weights, once at start: every rank then applies the same mean
gradients), ``shard_batch``/``batch_sharding`` (``P(DATA_AXIS)``) is the
contiguous block :func:`shard_slice` a rank takes of a batch, and
``rollout_pspec`` is each rank's own block of the envs with its own
rollout storage.

The backend follows from what the code sees: NCCL where every rank on a
host has a card of its own, gloo where ranks share a card (NCCL refuses two
ranks on one device) and on the CPU.  Gloo reduces CUDA tensors only by
``broadcast`` and ``all_reduce``; everything else goes through the CPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import pickle
import re
import shutil
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_PORT = 8476  # the coordinator port of the JAX package's SLURM rendezvous
# the rendezvous' and every collective's limit: a rank that dies or hangs
# fails its peers' next collective instead of leaving them waiting
TIMEOUT = datetime.timedelta(minutes=30)


def slurm_first_host(nodelist: str) -> str:
    """First hostname of a (possibly compressed) SLURM nodelist.

    SLURM compresses allocations as ``nid[001-004]`` or
    ``gpu[1,3-5]-rack,cpu7``; the coordinator must be the first *expanded*
    host (``nid001``), not the literal prefix (``nid``).  Commas inside
    brackets are range separators, outside they separate hosts."""
    depth = 0
    first = []
    for ch in nodelist:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            break
        first.append(ch)

    def expand(m):
        # first element of the bracket list; a range "001-004" keeps its
        # zero-padded lower bound
        return m.group(1).split(",")[0].split("-")[0]

    return re.sub(r"\[([^\]]*)\]", expand, "".join(first))


def shard_slice(n: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s contiguous block of ``n`` rows (``P(DATA_AXIS)``);
    ``world`` must divide ``n``."""
    if n % world:
        raise ValueError(f"{n} rows do not split evenly over {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def rank_seed(seed: int, group: Optional["Group"]) -> int:
    """The seed of a rank's generators: ``seed`` itself in one process, a
    distinct stream per rank drawn from ``(seed, rank)`` in a group (the
    JAX package folds the axis index into its key)."""
    if group is None:
        return seed
    import numpy as np

    return int(np.random.SeedSequence([seed, group.rank]).generate_state(1, np.uint64)[0]
               >> 1)


@dataclasses.dataclass
class Group:
    """One rank's handle on the data-parallel group: its ``rank`` of
    ``world``, its place on its host (``local_rank`` of ``local_world``;
    ranks are placed on hosts in blocks, as SLURM and ``torchrun`` place
    them), its ``device`` and the ``backend``.  Host objects travel over
    ``cpu_group`` (gloo; the default group where that is gloo already)."""

    rank: int
    world: int
    device: torch.device
    backend: str
    local_rank: int = 0
    local_world: int = 1
    cpu_group: Any = None

    @property
    def node(self) -> int:
        return self.rank // self.local_world

    @property
    def nodes(self) -> int:
        return self.world // self.local_world

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def all_reduce_(self, tensors: Sequence[torch.Tensor], op: str = "sum"
                    ) -> List[torch.Tensor]:
        """Sum (``op="sum"``) or average (``"mean"``) ``tensors`` over the
        ranks in place, as one flattened buffer in the first tensor's dtype:
        one collective for the whole list."""
        tensors = list(tensors)
        if not tensors:
            return tensors
        flat = torch.cat([t.detach().reshape(-1).to(tensors[0].dtype) for t in tensors])
        dist.all_reduce(flat)
        if op == "mean":
            # a device tensor: CUDA divides by a host scalar as a multiply
            # by its reciprocal, which the CPU does not
            flat = flat / torch.tensor(float(self.world), dtype=flat.dtype, device=flat.device)
        elif op != "sum":
            raise ValueError(f"all_reduce_ op must be 'sum' or 'mean', got {op!r}")
        offset = 0
        with torch.no_grad():
            for t in tensors:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
        return tensors

    def broadcast_module(self, module: torch.nn.Module, src: int = 0) -> None:
        """Copy rank ``src``'s parameters and buffers into every rank's
        ``module``: one broadcast per dtype."""
        by_dtype: dict = {}
        for t in list(module.parameters()) + list(module.buffers()):
            by_dtype.setdefault(t.dtype, []).append(t)
        with torch.no_grad():
            for ts in by_dtype.values():
                flat = torch.cat([t.reshape(-1) for t in ts])
                dist.broadcast(flat, src)
                offset = 0
                for t in ts:
                    t.copy_(flat[offset:offset + t.numel()].view_as(t))
                    offset += t.numel()

    def all_gather_object(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank (over the CPU)."""
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.cpu_group)
        return out

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s ``obj`` on every rank (over the CPU)."""
        box = [obj]
        dist.broadcast_object_list(box, src, group=self.cpu_group)
        return box[0]

    def any(self, flag: bool) -> bool:
        """True on every rank where ``flag`` is true on any rank."""
        t = torch.tensor([int(bool(flag))])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.cpu_group)
        return bool(t.item())

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def _rank_device(device, local_rank: int, local_world: int):
    """(device, backend) of a rank: a bare ``cuda`` (or None) spreads the
    host's ranks over its cards, ``cuda:k`` puts them all on card k, and
    ``cpu`` keeps them on the CPU.  NCCL where each rank has a card of its
    own, gloo otherwise."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return device, "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    n_cards = torch.cuda.device_count()
    if device.index is None:
        device = torch.device("cuda", local_rank % n_cards)
        own_card = local_world <= n_cards
    else:
        own_card = local_world == 1
    return device, ("nccl" if own_card else "gloo")


def _join(rank: int, world: int, device, init_method: str, local_rank: int,
          local_world: int) -> Group:
    device, backend = _rank_device(device, local_rank, local_world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    cpu_group = dist.new_group(backend="gloo", timeout=TIMEOUT) if backend == "nccl" else None
    logging.getLogger(__name__).info(
        "rank %d of %d on %s (%d of %d on its host), backend %s", rank, world, device,
        local_rank, local_world, backend)
    return Group(rank, world, device, backend, local_rank, local_world, cpu_group)


def _first_int(text: Optional[str]) -> Optional[int]:
    m = re.match(r"\d+", text or "")
    return int(m.group()) if m else None


def init_distributed(device=None) -> Optional[Group]:
    """Join the group of a process started as one of several ranks (the
    ``init_distrib_slurm`` analogue): rank and world from ``SLURM_PROCID``
    and ``SLURM_NTASKS``, else ``torchrun``'s ``RANK`` and ``WORLD_SIZE``;
    the coordinator from ``MASTER_ADDR``/``MASTER_PORT``, else the first
    host of ``SLURM_STEP_NODELIST`` on port 8476.  A single process (one
    task, no ``WORLD_SIZE`` above 1) is a no-op and returns None."""
    env = os.environ
    if int(env.get("SLURM_NTASKS", "1")) > 1:
        world, rank = int(env["SLURM_NTASKS"]), int(env.get("SLURM_PROCID", "0"))
        local_rank = int(env.get("SLURM_LOCALID", rank))
        local_world = _first_int(env.get("SLURM_STEP_TASKS_PER_NODE")) or world
    elif int(env.get("WORLD_SIZE", "1")) > 1:
        world, rank = int(env["WORLD_SIZE"]), int(env.get("RANK", "0"))
        local_rank = int(env.get("LOCAL_RANK", rank))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    else:
        return None
    addr = env.get("MASTER_ADDR") or slurm_first_host(env.get("SLURM_STEP_NODELIST",
                                                              "localhost"))
    port = env.get("MASTER_PORT", str(DEFAULT_PORT))
    return _join(rank, world, device, f"tcp://{addr}:{port}", local_rank, local_world)


def _spawned_rank(rank, world, device, root, threads):
    torch.set_num_threads(threads)
    with open(os.path.join(root, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    group = _join(rank, world, device, f"file://{os.path.join(root, 'store')}", rank, world)
    try:
        out = fn(group, *args)
        if rank == 0:
            with open(os.path.join(root, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        group.close()


def spawn(fn: Callable, world: int, device=None, *args):
    """Run ``fn(group, *args)`` in ``world`` processes on this host (the
    ``spawn`` start method: the caller may hold a CUDA context) and return
    rank 0's result.  The ranks meet through a file store in a temporary
    directory, which also carries ``fn`` and ``args`` (a pipe would hold
    each rank's start until the one before it had read them), and split
    the caller's torch threads.  A rank that raises stops the others and
    raises here."""
    import torch.multiprocessing as mp

    if world < 1:
        raise ValueError(f"world must be at least 1, got {world}")
    _rank_device(device, 0, world)  # a missing card fails here, not in every rank
    root = tempfile.mkdtemp(prefix="pnvo_dist_")
    try:
        with open(os.path.join(root, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        threads = max(1, torch.get_num_threads() // world)
        mp.start_processes(_spawned_rank, nprocs=world, join=True, start_method="spawn",
                           args=(world, None if device is None else str(device), root,
                                 threads))
        with open(os.path.join(root, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)

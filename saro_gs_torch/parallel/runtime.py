"""Process-group start-up, the rank's device and the (data, tile) mesh
(counterpart of parallel/runtime.py, and of shard.make_mesh; the JAX
package's global_mesh is ``make_mesh``, whose mesh always spans the whole
group).

The JAX package runs one program over a mesh of devices.  Here each
device is a process, a rank of one ``torch.distributed`` group: rank r is
(data r // n_tile, tile r % n_tile).  The ranks of one data index form
its tile group, which shares each view's render by strips of tile rows;
the ranks of one tile index form its data group, which shares the view
batch.  Every rank holds the whole model state, and the collectives keep
the copies equal to the bit.

Launch on one host:

    torchrun --nproc_per_node N -m saro_gs_torch.cli train -s <data> \\
        --config <json with mesh_data * mesh_tile = N> [--device cpu]

torchrun sets WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR
and MASTER_PORT, which ``init_distributed`` reads.  ``launch_local``
starts the ranks itself, with a ``file://`` store (the tests,
chip_smoke.py).

Backend: nccl where every rank of the host has a card of its own, else
gloo (ranks sharing one card, or on the CPU).  Gloo takes CUDA tensors
for all_reduce and broadcast only, through host copies; comm.py needs
nothing else.
"""
from __future__ import annotations

import datetime
import os
import queue
import time
import traceback
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

# long enough for rank 0's eval and checkpoints while the others wait at
# the barrier after them
DEFAULT_TIMEOUT_S = 1800.0


def group_rank() -> int:
    """This process's rank in the group (0 outside one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def group_size() -> int:
    """The group's number of ranks (1 outside one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", group_rank()))


def choose_backend(local_world_size: int, cards: int) -> str:
    """nccl where each of the host's ranks has a card of its own, gloo
    where ranks share one or run on the CPU (``cards`` 0)."""
    return "nccl" if 0 < local_world_size <= cards else "gloo"


def rank_device(device="cuda") -> torch.device:
    """``device`` for this rank: a CUDA device without an index becomes
    card LOCAL_RANK % device_count (ranks past the host's cards share
    them)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None, device="cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Join the process group if this run has more than one process;
    returns this process's rank.

    With no arguments it reads torchrun's environment (``env://``); one
    process and no ``init_method`` is a no-op.  ``backend`` None picks by
    ``choose_backend`` for ``device`` (gloo for the CPU) and rank 0
    prints the choice.  A failed start raises: no other backend is
    tried."""
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    world = int(env.get("WORLD_SIZE", 1)) if world_size is None \
        else world_size
    if world == 1 and init_method is None:
        return 0
    rank = int(env.get("RANK", 0)) if rank is None else rank
    on_cuda = torch.device(device).type == "cuda"
    cards = torch.cuda.device_count() if on_cuda else 0
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    backend = backend or choose_backend(local_world, cards)
    if cards:
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)) % cards)
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    if rank == 0:
        print(f"[distributed] {world} ranks, backend {backend} "
              f"({local_world} on this host, {cards} card(s) for them)",
              flush=True)
    return rank


def host_shard(items: Sequence, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> List:
    """Round-robin share ``items[i::n]`` of rank i of n (default: this
    process of the group), so that every share spreads over the whole
    list."""
    i = group_rank() if process_index is None else process_index
    n = group_size() if process_count is None else process_count
    return list(items[i::n])


class Mesh(NamedTuple):
    """This rank's place on a (data, tile) mesh and the groups of its two
    axes (None for an axis of one rank)."""
    n_data: int
    n_tile: int
    data_rank: int
    tile_rank: int
    data_group: Optional[dist.ProcessGroup]
    tile_group: Optional[dist.ProcessGroup]


def make_mesh(n_data: int = 1, n_tile: int = 1) -> Mesh:
    """The group's ranks as an n_data x n_tile mesh, data-major (rank r
    is data r // n_tile, tile r % n_tile).  Collective: every rank calls
    it, with the same shape.  The shape must use every rank."""
    world = group_size()
    need = n_data * n_tile
    if need != world:
        if world == 1:
            raise RuntimeError(
                f"a {n_data}x{n_tile} mesh needs {need} processes and this "
                f"run has one: launch it with torchrun --nproc_per_node "
                f"{need} (or parallel.runtime.launch_local)")
        raise ValueError(f"a {n_data}x{n_tile} mesh needs {need} ranks; "
                         f"the group has {world}")
    data_rank, tile_rank = divmod(group_rank(), n_tile)
    data_group = tile_group = None
    # dist.new_group is collective: every rank makes every group, in one
    # order
    if n_tile > 1:
        for d in range(n_data):
            group = dist.new_group([d * n_tile + t for t in range(n_tile)])
            if d == data_rank:
                tile_group = group
    if n_data > 1:
        for t in range(n_tile):
            group = dist.new_group([d * n_tile + t for d in range(n_data)])
            if t == tile_rank:
                data_group = group
    return Mesh(n_data, n_tile, data_rank, tile_rank, data_group,
                tile_group)


def make_global_batch(local_batch):
    """The train step's input from this rank's batch.  The JAX package
    assembles the hosts' views into one array sharded over the data axis;
    here each rank keeps its own views and the step reduces across the
    data group, so the batch is returned as it is, once every leaf is
    found to hold the same number of views."""
    def leaves(x):
        if isinstance(x, (tuple, list)):
            for y in x:
                yield from leaves(y)
        else:
            yield x
    sizes = {int(x.shape[0]) for x in leaves(local_batch)}
    if len(sizes) != 1:
        raise ValueError(f"the batch's leaves hold {sorted(sizes)} views")
    return local_batch


def _rank_main(rank, world, init_method, backend, device, timeout_s, fn,
               args, results):
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    try:
        init_distributed(init_method, world, rank, backend, device,
                         timeout_s)
        out = fn(rank, *args)
        # no rank leaves while a peer may still be setting up a group
        dist.barrier()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch_local(fn, world_size: int, args: tuple = (), *,
                 init_method: str, backend: Optional[str] = None,
                 device="cuda", timeout_s: float = 120.0) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` new processes (spawned)
    that form one group through ``init_method`` (e.g. ``file://<path>``,
    a file that does not exist yet); returns their results by rank.

    ``fn`` and ``args`` are pickled: ``fn`` is a function importable by
    name.  The whole run has ``timeout_s`` (also each collective's
    timeout).  A rank that raises or dies, or a run past its time, stops
    every rank, and this raises with the failed ranks' tracebacks."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, init_method, backend, device,
                               timeout_s, fn, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    out, errors = {}, {}

    def receive(timeout):
        rank, ok, value = results.get(timeout=timeout)
        (out if ok else errors)[rank] = value
    try:
        while len(out) < world_size and not errors:
            try:
                receive(1.0)
                continue
            except queue.Empty:
                pass
            dead = [r for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0) and r not in out]
            if dead:
                # a dead rank's report may still be on its way
                try:
                    receive(5.0)
                except queue.Empty:
                    errors.update({r: f"exit code {procs[r].exitcode}, no "
                                      "report" for r in dead})
            elif time.monotonic() > deadline:
                late = sorted(set(range(world_size)) - set(out))
                raise TimeoutError(f"ranks {late} not done after "
                                   f"{timeout_s} s")
        # the first failure may be another rank's consequence: a few
        # seconds for the others' reports
        end = time.monotonic() + (5.0 if errors else 0.0)
        while len(out) + len(errors) < world_size and \
                time.monotonic() < end:
            try:
                receive(0.5)
            except queue.Empty:
                pass
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0) if not errors
                   else 0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("".join(f"rank {r} failed:\n{e}\n"
                                   for r, e in sorted(errors.items())))
    bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if bad:
        raise RuntimeError(f"ranks exited with codes {bad}")
    return [out[r] for r in range(world_size)]

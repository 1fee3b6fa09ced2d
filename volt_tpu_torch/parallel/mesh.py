"""Device meshes over ``torch.distributed`` (port of
:mod:`volt_tpu.parallel.mesh`).

The same 2-D logical mesh ``(asset, path)``: the ``asset`` axis carries the
independent per-asset fits, the ``path`` axis the Monte-Carlo paths of the
rollout.  JAX lays devices out in a mesh and lets XLA insert the
collectives; here one process drives one device, the ranks of the default
process group are laid out row-major in the mesh, and each axis has its
sub-groups (``torch.distributed.new_group``), over which :class:`Mesh`
gathers and reduces the few tensors that cross ranks.

Backends follow the devices: NCCL for CUDA, gloo for the CPU.  Gloo on CUDA
devices is allowed when asked for (NCCL refuses two ranks on one card): its
collectives are staged through host memory.
"""

from __future__ import annotations

import dataclasses
import datetime
import io
import itertools
import math
import os
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "multihost_initialize", "spawn_world"]

# Launchers whose environment tells ``init_process_group("env://")`` or the
# caller that this process is one of many: each entry is a set of variables
# that must all be set.
_CLUSTER_ENV_VARS = (
    ("MASTER_ADDR", "WORLD_SIZE"),   # torchrun and hand-made launchers
    ("TORCHELASTIC_RUN_ID",),        # torchrun / torch.distributed.elastic
    ("SLURM_JOB_ID",),               # SLURM
    ("OMPI_COMM_WORLD_SIZE",),       # OpenMPI's mpirun
)


def _cluster_detected() -> bool:
    return any(all(os.environ.get(v) for v in group)
               for group in _CLUSTER_ENV_VARS)


def multihost_initialize(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         detect: str = "env", **kwargs) -> bool:
    """Join this process to a multi-process world
    (``torch.distributed.init_process_group``), with the JAX function's
    contract:

    * single process: no explicit argument, ``detect="env"`` and no
      launcher environment (``MASTER_ADDR`` with ``WORLD_SIZE``,
      ``TORCHELASTIC_RUN_ID``, ``SLURM_JOB_ID``, ``OMPI_COMM_WORLD_SIZE``):
      returns ``False`` and touches nothing;
    * multi-process: any explicit argument (``coordinator_address`` as
      ``host:port`` or an ``init_method`` URL, ``num_processes``,
      ``process_id``, or keyword arguments of ``init_process_group`` such
      as ``backend`` and ``timeout``), a launcher environment, or
      ``detect="force"``: initialises and returns ``True``.  Errors
      propagate: a misconfigured cluster fails, it does not run as one
      process;
    * idempotent: with a process group already initialised it returns
      ``False`` and does nothing.
    """
    if detect not in ("env", "force"):
        raise ValueError("detect must be 'env' or 'force'")
    if dist.is_initialized():
        return False
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None or bool(kwargs))
    if not explicit and not _cluster_detected() and detect != "force":
        return False
    if coordinator_address is not None:
        kwargs["init_method"] = (coordinator_address
                                 if "://" in coordinator_address
                                 else f"tcp://{coordinator_address}")
    dist.init_process_group(
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, **kwargs)
    return True


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a logical mesh: the axis names and sizes, its
    coordinates, its device, and per axis the process group of the ranks
    that differ from it only along that axis (``groups``; empty, and
    ``backend`` ``None``, in a world of one without a process group)."""

    axis_names: tuple
    shape: tuple
    coords: tuple
    device: torch.device
    backend: str | None
    groups: dict

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def axis_index(self, name: str) -> int:
        return self.coords[self.axis_names.index(name)]

    def shard(self, tensor, axes):
        """This rank's block of a global tensor (or array): dim ``i`` split
        evenly over the mesh axis ``axes[i]`` (``None``: not split).
        ``ValueError`` if a dim does not divide by its axis."""
        for dim, name in enumerate(axes):
            if name is None:
                continue
            parts, size = self.axis_size(name), tensor.shape[dim]
            if size % parts:
                raise ValueError(f"dim {dim} of size {size} does not split "
                                 f"over the {parts}-way {name!r} mesh axis")
            start = self.axis_index(name) * (size // parts)
            tensor = tensor[(slice(None),) * dim
                            + (slice(start, start + size // parts),)]
        return tensor

    def gather(self, tensor, axes):
        """The inverse of :meth:`shard`: the global tensor from every rank's
        block, on every rank (an all-gather per split axis)."""
        for dim, name in enumerate(axes):
            if name is not None and self.backend is not None:
                tensor = self._all_gather(tensor, dim, name)
        return tensor

    def all_reduce(self, tensor, axis: str):
        """The sum of ``tensor`` over the ranks along ``axis``."""
        if self.backend is None:
            return tensor
        staged = self._staged(tensor).contiguous()
        dist.all_reduce(staged, group=self.groups[axis])
        return staged.to(tensor.device)

    def _staged(self, tensor):
        # gloo on a CUDA device: the collective runs on a host copy
        return tensor.cpu() if self.backend == "gloo" else tensor

    def _all_gather(self, tensor, dim, axis):
        staged = self._staged(tensor).contiguous()
        parts = [torch.empty_like(staged)
                 for _ in range(self.axis_size(axis))]
        dist.all_gather(parts, staged, group=self.groups[axis])
        return torch.cat(parts, dim=dim).to(tensor.device)

    def seeded(self, generator, axes):
        """A generator on ``generator``'s device whose stream is fixed by
        ``generator.initial_seed()`` and this rank's coordinates along
        ``axes`` (``None`` for ``None``): ranks that share those
        coordinates draw alike."""
        if generator is None:
            return None
        seed = np.random.SeedSequence(
            [generator.initial_seed(), *(self.axis_index(a) for a in axes)])
        return torch.Generator(device=generator.device).manual_seed(
            int(seed.generate_state(1, np.uint64)[0]))


def make_mesh(axis_sizes=None, axis_names=("asset", "path"), devices=None,
              backend: str | None = None) -> Mesh:
    """This rank's :class:`Mesh` over the world of the default process group
    (a world of one without one).

    ``axis_sizes=None`` puts every rank on the first axis; their product
    must equal the world size.  ``devices``: one device per rank (e.g.
    ``["cpu"] * world``); by default ``cuda:{LOCAL_RANK}`` (the rank when
    the launcher sets none, modulo the visible cards).  ``backend`` of the
    axis groups: by default NCCL when every device is CUDA, else gloo;
    ``"gloo"`` may be asked for on CUDA devices (collectives staged through
    host memory), ``"nccl"`` on a CPU device raises.  Every rank must call
    this with the same arguments: each axis group is created on every
    rank, in the same order.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    axis_names = tuple(axis_names)
    if axis_sizes is None:
        axis_sizes = (world,) + (1,) * (len(axis_names) - 1)
    axis_sizes = tuple(int(a) for a in axis_sizes)
    if len(axis_sizes) != len(axis_names) or math.prod(axis_sizes) != world:
        raise ValueError(f"mesh {axis_sizes} over axes {axis_names} does not "
                         f"cover {world} ranks")
    if devices is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        cards = torch.cuda.device_count()
        devices = [torch.device("cuda", local % cards if cards else local)
                   ] * world
    devices = [torch.device(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    on_cuda = all(d.type == "cuda" for d in devices)
    if backend is None:
        backend = "nccl" if on_cuda else "gloo"
    elif backend not in ("nccl", "gloo") or (backend == "nccl"
                                              and not on_cuda):
        raise ValueError(f"backend {backend!r} cannot serve the devices "
                         f"{sorted({str(d) for d in devices})}")
    device = devices[rank]
    if device.type == "cuda" and dist.is_initialized():
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)  # NCCL's communicators use it
    coords = tuple(np.unravel_index(rank, axis_sizes))
    groups = {}
    if dist.is_initialized():
        for i, name in enumerate(axis_names):
            others = [range(s) if j != i else (0,)
                      for j, s in enumerate(axis_sizes)]
            for base in itertools.product(*others):
                ranks = [int(np.ravel_multi_index(
                    base[:i] + (k,) + base[i + 1:], axis_sizes))
                    for k in range(axis_sizes[i])]
                group = dist.new_group(ranks, backend=backend)
                if rank in ranks:
                    groups[name] = group
    return Mesh(axis_names=axis_names, shape=axis_sizes,
                coords=tuple(int(c) for c in coords), device=device,
                backend=backend if dist.is_initialized() else None,
                groups=groups)


# ---------------------------------------------------------------------------
# a world of processes on this host
# ---------------------------------------------------------------------------


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree.cpu() if torch.is_tensor(tree) else tree


def _dumps(obj) -> bytes:
    # bytes, not tensors, cross the process boundary: a tensor pickled by
    # torch.multiprocessing is shared through a file descriptor that dies
    # with the process that sent it
    buf = io.BytesIO()
    torch.save(_to_cpu(obj), buf)
    return buf.getvalue()


def _loads(data: bytes):
    # written by this module's own processes (``_dumps``)
    return torch.load(io.BytesIO(data), weights_only=False)


def _rank_main(rank, world, port, timeout, threads, fn, args, out):
    torch.set_num_threads(threads)
    try:
        multihost_initialize(f"127.0.0.1:{port}", world, rank,
                             backend="gloo",
                             timeout=datetime.timedelta(seconds=timeout))
        try:
            out.put((rank, "ok", _dumps(fn(rank, *_loads(args)))))
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))
        raise


def spawn_world(fn, world: int, args=(), timeout: float = 300.0):
    """Run ``fn(rank, *args)`` in ``world`` fresh processes (start method
    ``spawn``) joined in one gloo process group on this host (a free
    localhost port; gloo, as NCCL refuses two ranks on one card), and
    return their results by rank, tensors moved to the CPU.  ``fn`` must
    be importable by name from its module.  Raises if a rank raises or
    dies, or if the world has not finished within ``timeout`` seconds (a
    hung rendezvous or collective); every rank is stopped before it
    returns or raises.  Each rank gets an equal share of this process's
    intra-op threads."""
    import multiprocessing

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    threads = max(1, torch.get_num_threads() // world)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(rank, world, port, timeout, threads,
                               fn, _dumps(tuple(args)), out))
             for rank in range(world)]
    deadline = time.monotonic() + timeout
    results = {}
    try:
        for p in procs:
            p.start()
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"the world of {world} did not finish in "
                                   f"{timeout} s (ranks done: "
                                   f"{sorted(results)})")
            try:
                rank, status, payload = out.get(timeout=min(1.0, left))
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"ranks exited early: {dead} "
                                       f"(rank, exit code)")
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                   f"{payload}")
            results[rank] = _loads(payload)
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                raise TimeoutError(f"a rank of {world} did not exit")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
    return [results[r] for r in range(world)]

"""Data parallelism over processes (counterpart of ``speedplusbaseline_tpu/
parallel/mesh.py``).

The JAX package shards the global batch over a 1-axis device mesh and lets
GSPMD insert the collectives, so a step over N devices gives the
parameters, BatchNorm statistics and losses of the one-device step on the
same global batch. The port runs one process per device and keeps those
semantics by hand, with ``all_reduce`` and ``broadcast`` only (the two
collectives gloo serves on CUDA tensors too):

* each rank loads its contiguous B/N rows of every global batch
  (``rank_rows``; data/loader.py) and draws the random numbers of the whole
  global batch, keeping its rows (engine/steps.py);
* BatchNorm in training mode normalizes with the global batch's statistics
  (models/layers.py::BatchNorm);
* every rank computes the loss of the global batch from its own rows'
  outputs and the other ranks' (``global_rows``), so its backward reaches
  only its own rows, and the sum over ranks of the gradients is the global
  gradient (``all_reduce_grads``, between ``backward()`` and the clip);
* parameters start equal (``broadcast_params``).

Not torch's ``DistributedDataParallel``: its BatchNorm statistics are per
replica, its wrapper renames every checkpoint key to ``module.*``, and
DANN calls the model twice before one backward.

Every one of these is a no-op without a default process group, so the
one-process path is unchanged. A process group of world 1 (chip_smoke's
NCCL check) runs the collective path.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue
import tempfile
import warnings
from typing import Any, Callable, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# A collective that one rank never reaches fails after this long instead of
# hanging its peers.
TIMEOUT = datetime.timedelta(seconds=300)


def backend(device_type: str) -> str:
    """NCCL on CUDA, gloo on the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def maybe_initialize_distributed(device_type: str) -> bool:
    """Join the process group a ``torchrun`` launch describes in the
    environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), the counterpart of JAX's multi-host init. Returns
    whether a default process group exists afterwards."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return False
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend(device_type), init_method="env://", timeout=TIMEOUT)
    return True


def make_mesh(num_devices: int = 0, batch_size: int = 0, device_type: str = "cuda") -> int:
    """The number of data-parallel processes, with the JAX package's rules:
    ``num_devices`` 0 means every local device (``torch.cuda.device_count()``
    on CUDA, 1 on the CPU); the count is capped at the CUDA devices present
    (an explicit N on the CPU runs N processes over gloo); with
    ``batch_size``, it is clamped to the largest divisor of the batch, with a
    warning, since the devices left out idle."""
    available = torch.cuda.device_count() if device_type == "cuda" else None
    requested = num_devices if num_devices > 0 else (available or 1)
    cap = requested if available is None else max(1, min(requested, available))
    n = cap
    if batch_size > 0:
        while n > 1 and batch_size % n != 0:
            n -= 1
        if n < cap:
            warnings.warn(
                f"make_mesh: batch_size={batch_size} is not divisible by the "
                f"{cap} available devices; clamping the data mesh to {n} device(s) "
                f"and IDLING the rest. Pick a batch_size divisible by the device "
                f"count to use all chips.", RuntimeWarning, stacklevel=2)
    return n


def rank_world() -> Optional[Tuple[int, int]]:
    """(rank, world size) of the default process group, or None without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return None


def is_main() -> bool:
    """True on rank 0 and in a process with no process group: the one
    process that writes logs, dumps and checkpoints."""
    rw = rank_world()
    return rw is None or rw[0] == 0


def rank_rows(global_batch: int, rank: int, world: int) -> slice:
    """The contiguous rows of a global batch that ``rank`` holds."""
    if global_batch % world != 0:
        raise ValueError(f"a global batch of {global_batch} does not split over {world} ranks")
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)


def global_batch(local_batch: int) -> Tuple[int, slice]:
    """(global batch size, this rank's rows of it) for a local batch of
    ``local_batch`` rows; (local_batch, all rows) without a process group."""
    rw = rank_world()
    if rw is None:
        return local_batch, slice(None)
    rank, world = rw
    total = local_batch * world
    return total, rank_rows(total, rank, world)


def global_rows(local: torch.Tensor) -> torch.Tensor:
    """The global batch's tensor of which ``local`` holds this rank's rows:
    one ``all_reduce`` of a zero-filled buffer (adding zeros is exact, so
    every row is the bits its rank computed). The other ranks' rows carry no
    gradient; this rank's rows are ``local`` itself, so a loss of the
    result back-propagates into this rank's rows only. ``local`` itself
    without a process group."""
    rw = rank_world()
    if rw is None:
        return local
    total, rows = global_batch(local.shape[0])
    buf = local.new_zeros((total, *local.shape[1:]))
    buf[rows] = local.detach()
    dist.all_reduce(buf)
    if not local.requires_grad:
        return buf
    return torch.cat([buf[:rows.start], local, buf[rows.stop:]])


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, differentiable: the gradient of each
    rank's ``t`` is the sum of the ranks' gradients of the result (what
    BatchNorm's global statistics need, as every rank's loss reads them)."""
    return _AllReduceSum.apply(t)


def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum the gradients over the ranks with one flattened ``all_reduce``.
    Each rank's gradient is its own rows' share of the global batch's loss
    (``global_rows``), so the sum is the global gradient. A no-op without a
    process group."""
    if rank_world() is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


@torch.no_grad()
def broadcast_params(model: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers to every rank (at the start, and
    after a resume or a pretrained load). A no-op without a process group."""
    if rank_world() is None:
        return
    for t in [*model.parameters(), *model.buffers()]:
        dist.broadcast(t.data, 0)


def barrier(device: torch.device) -> None:
    """Wait until every rank arrives (an ``all_reduce`` of one element on
    ``device``). A no-op without a process group."""
    if rank_world() is not None:
        dist.all_reduce(torch.zeros(1, device=device))


def _rank_main(rank: int, world: int, init_method: str, backend_name: str, threads: int,
               fn: Callable, args: Sequence[Any], results) -> None:
    """One spawned rank: join the group, run ``fn(*args)``, send back
    (rank, ok, the pickled result or exception). Pickled here, by value:
    the queue would share a tensor's memory with the parent through this
    process, which exits."""
    try:
        torch.set_num_threads(threads)
        if backend_name == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend_name, init_method=init_method, rank=rank,
                                world_size=world, timeout=TIMEOUT)
        try:
            out = fn(*args)
        finally:
            if dist.is_initialized():  # fn may have left the group itself
                dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException as e:  # noqa: BLE001 -- sent to the parent, which re-raises it
        try:
            payload = pickle.dumps(e)
        except Exception:  # noqa: BLE001 -- an exception that does not pickle
            payload = pickle.dumps(RuntimeError(f"rank {rank}: {e!r}"))
        results.put((rank, False, payload))


def spawn(fn: Callable, args: Sequence[Any], world: int, backend_name: str,
          threads: int = 1) -> Any:
    """Run ``fn(*args)`` in ``world`` new processes that form one process
    group over ``backend_name``; rendezvous through a ``file://`` store in a
    temporary directory (no port to race for). Returns rank 0's result; the
    first error a rank raises is raised here, and the other ranks are ended.
    ``fn`` must be importable by name (a module-level function)."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(r, world, init, backend_name, threads,
                                                      fn, tuple(args), results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got, error = {}, None
        try:
            while len(got) < world and error is None:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead and results.empty():
                        error = RuntimeError(f"a rank exited with code {dead[0]} and no result")
                    continue
                if ok:
                    got[rank] = pickle.loads(out)
                else:
                    error = pickle.loads(out)
        finally:
            for p in procs:
                p.join(timeout=10 if error is None else 2)
                if p.is_alive():
                    p.terminate()
                    p.join()
    if error is not None:
        raise error
    return got[0]


def _cli_rank(fn: Callable, cfg) -> Any:
    """A CLI's run on one spawned rank: rank r takes CUDA device r."""
    if cfg.use_cuda:
        cfg.gpu_id = dist.get_rank()
    return fn(cfg)


def launch(fn: Callable, cfg) -> Any:
    """Run a CLI's ``fn(cfg)`` over ``cfg.num_devices`` data-parallel
    processes and return rank 0's result. Under ``torchrun`` this process is
    one rank; otherwise ``make_mesh`` sets the count, and above 1 the ranks
    are spawned here, after the CUDA kernels are built once, so that two
    ranks never compile into the build directory at once."""
    device_type = "cuda" if cfg.use_cuda else "cpu"
    if maybe_initialize_distributed(device_type):
        world = dist.get_world_size()
        if cfg.batch_size % world != 0:
            raise ValueError(f"--batch_size {cfg.batch_size} does not split over the "
                             f"{world} ranks of this launch")
        if cfg.use_cuda:
            cfg.gpu_id = int(os.environ.get("LOCAL_RANK", 0))
        return fn(cfg)
    world = make_mesh(cfg.num_devices, cfg.batch_size, device_type)
    if world == 1:
        return fn(cfg)
    if cfg.use_cuda:
        from ..ops import _build

        _build.build_all()
    threads = max(1, torch.get_num_threads() // world)
    return spawn(_cli_rank, (fn, cfg), world, backend(device_type), threads)

"""Multi-process data parallelism over ``torch.distributed``; the
counterpart of ``myimagecaptioningmodel_tpu/parallel/distributed.py``.

One process per GPU, as PyTorch runs data parallelism: ``torchrun`` (its
``env://`` variables), or explicit addresses through ``initialize``. The
backend is NCCL on CUDA and gloo on the CPU. Every process runs the same
program on its own rows of each global batch (``host_local_slice``,
``local_rows``); the train step all-reduces gradients and the train-mode BN
its statistics, so every rank holds the same parameters bit for bit.

    from myimagecaptioningmodel_tpu_torch.parallel import distributed
    distributed.initialize()          # under torchrun
    loop.train(cfg)                   # batch_size stays the GLOBAL batch

Vocab tensor parallelism (``parallel/mesh.make_mesh`` with
``model_parallel`` > 1) lays the processes out as a (data, model) grid,
``rank = d * model_parallel + m`` (the JAX package's ``reshape(n // mp,
mp)``): ``set_grid`` makes the data groups (the ranks of one ``m``) and the
model groups (the ranks of one ``d``). The batch helpers then slice by the
data index and size (the ranks of a model group hold the same rows), and
the collectives take a ``group`` (default: every process). Outside a grid
the data group is every process, and there is no model group.

Each collective this module issues adds one to its function's ``calls``
(``all_reduce_sum_.calls``, ``broadcast_.calls``, ``all_gather_rows.calls``,
``all_reduce_max_.calls``), so a run can count the collectives of a step.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import socket
from datetime import timedelta
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# a rank that dies or hangs fails its peers' next collective after this long
# instead of blocking them for good
COLLECTIVE_TIMEOUT = timedelta(minutes=10)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group (a no-op when it is already up).

    With no arguments the group comes from torchrun's ``env://`` variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); otherwise
    ``coordinator_address`` (``host:port`` or ``tcp://host:port``),
    ``num_processes`` and ``process_id`` name it. ``backend`` defaults to
    NCCL when CUDA is available and gloo otherwise; under NCCL the current
    CUDA device becomes this process's (``local_device``)."""
    if active():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None and num_processes is None and process_id is None:
        init_method = "env://"
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("coordinator_address, num_processes and process_id go together")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    if backend == "nccl":
        rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
        torch.cuda.set_device(local_device(rank=rank))
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes
                            if num_processes is not None else -1,
                            rank=process_id if process_id is not None else -1,
                            timeout=COLLECTIVE_TIMEOUT)


def add_cli_arguments(ap) -> None:
    """The multi-process flags of the ``train`` and ``evaluate`` entry
    points (the JAX package's ``train.py`` flags)."""
    ap.add_argument("--distributed", action="store_true",
                    help="join a process group (data parallelism); torchrun's "
                         "environment is joined without this flag")
    ap.add_argument("--coordinator", default=None,
                    help="process 0's address host:port (default: torchrun's env://)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)


def initialize_from_cli(args) -> bool:
    """Join the process group the parsed flags (``add_cli_arguments``) or
    torchrun's environment describe -> whether there is one. A ``--device
    cpu`` run takes gloo."""
    if not (args.distributed or "TORCHELASTIC_RUN_ID" in os.environ
            or args.coordinator is not None):
        return False
    backend = "gloo" if getattr(args, "device", None) == "cpu" else None
    initialize(args.coordinator, args.num_processes, args.process_id, backend=backend)
    return True


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    global _GRID
    _GRID = None
    if active():
        dist.destroy_process_group()


def active() -> bool:
    """True inside an initialized process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if active() else 1


def process_index() -> int:
    return dist.get_rank() if active() else 0


def is_main_process() -> bool:
    """True on the one process that owns filesystem side effects
    (checkpoints, exports, log files)."""
    return process_index() == 0


def local_device(rank: Optional[int] = None) -> torch.device:
    """This process's GPU: ``cuda:LOCAL_RANK`` under torchrun, else the rank
    modulo the host's GPU count."""
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    rank = process_index() if rank is None else rank
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def default_device(device=None):
    """An entry point's device: the caller's, else this process's GPU inside
    a process group (``local_device``), else None (the entry point's own
    default)."""
    if device is None and active():
        return local_device()
    return device


def comm_device() -> torch.device:
    """Where host-side values travel for a collective: the GPU under NCCL,
    the CPU under gloo."""
    if active() and dist.get_backend() == "nccl":
        return local_device()
    return torch.device("cpu")


def barrier() -> None:
    if active():
        dist.barrier()


# ---- the (data, model) grid ------------------------------------------------------


class _Grid:
    """This process's place in the (data, model) grid and its two groups."""

    def __init__(self, model_parallel: int) -> None:
        n, r = process_count(), process_index()
        self.model_parallel = model_parallel
        self.data_size, self.data_index = n // model_parallel, r // model_parallel
        self.model_index = r % model_parallel
        # every process makes every group, in one order (dist.new_group's rule)
        self.data_group = self.model_group = None
        for m in range(model_parallel):
            g = dist.new_group(list(range(m, n, model_parallel)))
            if m == self.model_index:
                self.data_group = g
        for d in range(self.data_size):
            g = dist.new_group(list(range(d * model_parallel, (d + 1) * model_parallel)))
            if d == self.data_index:
                self.model_group = g


_GRID: Optional[_Grid] = None


def set_grid(model_parallel: int) -> None:
    """Lay the process group out as (process_count // model_parallel,
    model_parallel) and make its groups (every process calls this, with the
    same value); 1 clears the grid."""
    global _GRID
    if model_parallel == 1:
        _GRID = None
        return
    if process_count() % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide the "
                         f"{process_count()} processes")
    _GRID = _Grid(model_parallel)


def model_parallel() -> int:
    return _GRID.model_parallel if _GRID is not None else 1


def data_size() -> int:
    """Processes along the data axis (that hold different rows)."""
    return _GRID.data_size if _GRID is not None else process_count()


def data_index() -> int:
    return _GRID.data_index if _GRID is not None else process_index()


def model_index() -> int:
    """This process's vocab slice along the model axis."""
    return _GRID.model_index if _GRID is not None else 0


def data_group():
    """The group of the processes that share this one's model index (None:
    every process)."""
    return _GRID.data_group if _GRID is not None else None


def model_group():
    """The group of the processes that share this one's rows (None outside a
    grid: only vocab tensor parallelism, which makes one, reduces over it)."""
    return _GRID.model_group if _GRID is not None else None


def host_local_slice(total: int) -> Tuple[int, int]:
    """(start, size) of this process's contiguous share of ``total`` samples
    (by its data index: a model group shares one)."""
    n, i = data_size(), data_index()
    base, rem = divmod(total, n)
    return i * base + min(i, rem), base + (1 if i < rem else 0)


def local_rows(batch):
    """This process's rows of a global batch (a numpy array or tensor whose
    leading axis divides by the data size), in global row order."""
    n = data_size()
    if batch.shape[0] % n:
        raise ValueError(f"global batch of {batch.shape[0]} rows does not divide over "
                         f"{n} processes")
    lb = batch.shape[0] // n
    i = data_index()
    return batch[i * lb:(i + 1) * lb]


# ---- collectives ---------------------------------------------------------------


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over every process of ``group`` (default: all), in place
    (every rank gets the same bits); a no-op outside a process group."""
    if active():
        dist.all_reduce(t, group=group)
        all_reduce_sum_.calls += 1
    return t


all_reduce_sum_.calls = 0


def all_reduce_max_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise maximum of ``t`` over the processes of ``group``, in place."""
    if active():
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        all_reduce_max_.calls += 1
    return t


all_reduce_max_.calls = 0


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every process, in place."""
    if active():
        dist.broadcast(t, src)
        broadcast_.calls += 1
    return t


broadcast_.calls = 0


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every process's ``t`` of ``group`` (default: all; equal shapes, on a
    device the backend gathers on) concatenated along the rows in rank
    order."""
    if not active():
        return t
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    all_gather_rows.calls += 1
    return torch.cat(parts)


all_gather_rows.calls = 0


def collective_calls() -> int:
    """Collectives issued by this process so far."""
    return (all_reduce_sum_.calls + all_reduce_max_.calls + broadcast_.calls
            + all_gather_rows.calls)


def reduce_flat_(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Sum a list of tensors over the processes of ``group`` (default: all)
    as one flat bucket per dtype (one all-reduce each) -> the summed
    tensors, in order and shapes of ``tensors``."""
    if not active():
        return list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        all_reduce_sum_(flat, group)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def put_tree(tree, src: int = 0):
    """Rank ``src``'s values of every tensor leaf of nested dicts and lists,
    broadcast to every process in place (one flat bucket per dtype and
    device) -> ``tree``."""
    if not active():
        return tree
    from myimagecaptioningmodel_tpu_torch.parallel.train_step import tree_leaves

    groups = {}
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            groups.setdefault((leaf.dtype, leaf.device), []).append(leaf)
    with torch.no_grad():
        for leaves in groups.values():
            flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
            broadcast_(flat, src)
            for leaf, part in zip(leaves, flat.split([leaf.numel() for leaf in leaves])):
                leaf.copy_(part.view_as(leaf))
    return tree


def sum_across_processes(values, group=None) -> np.ndarray:
    """Elementwise sum of a float vector over the processes of ``group``
    (default: all; itself in one process). float64: the JAX package's
    float32 is JAX's 32-bit default, and a BLEU sum kept in float64 is the
    single-process number's."""
    vals = np.asarray(values, np.float64)
    if not active():
        return vals
    t = torch.from_numpy(vals.copy()).to(comm_device())
    return all_reduce_sum_(t, group).cpu().numpy()


def global_distinct_count(sentences, group=None) -> int:
    """|union over processes| of each process's sentence set, without
    shipping strings: each sentence becomes a 64-bit blake2b hash (two int32
    lanes, as the JAX package gathers them), padded to the largest count and
    gathered; the union of hashes is counted. Collision odds at dev-set
    scale (~1e5 sentences) are ~1e-9."""
    if not active():
        return len(sentences)
    dev = comm_device()
    h = np.zeros((len(sentences), 2), np.int32)
    for i, s in enumerate(sorted(sentences)):
        h[i] = np.frombuffer(hashlib.blake2b(s.encode("utf-8"), digest_size=8).digest(),
                             np.int32)
    counts = all_gather_rows(torch.tensor([len(sentences)], dtype=torch.int32, device=dev),
                             group)
    counts = counts.cpu().numpy()
    m = int(counts.max())
    if m == 0:
        return 0
    padded = np.zeros((m, 2), np.int32)
    padded[: len(sentences)] = h
    gathered = all_gather_rows(torch.from_numpy(padded).to(dev), group).cpu().numpy()
    gathered = gathered.reshape(-1, m, 2)
    pairs = set()
    for p, c in enumerate(counts):
        pairs.update((int(a), int(b)) for a, b in gathered[p, :c])
    return len(pairs)


# ---- a local group of processes ---------------------------------------------------


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned(fn, rank, world, address, threads, out, args):
    try:
        if threads:
            torch.set_num_threads(threads)
        initialize(address, world, rank, backend="gloo")
        try:
            # pickled by value here: the queue's pickler would share a
            # tensor's memory with a process that is about to exit
            result = pickle.dumps(fn(rank, *args))
        finally:
            shutdown()
        out.put((rank, True, result))
    except BaseException as e:  # reported to the parent, which raises
        import traceback

        out.put((rank, False, f"{type(e).__name__}: {e}\n{traceback.format_exc()}"))


def spawn_local(fn: Callable, nprocs: int, args: tuple = (), timeout: float = 600.0,
                threads: int = 0) -> list:
    """Run ``fn(rank, *args)`` in ``nprocs`` fresh processes that form one
    gloo process group on this host (``tcp://localhost:<free port>``; gloo
    runs several ranks on one GPU, where NCCL refuses) -> each rank's
    return value, in rank order. ``fn`` and ``args`` are pickled
    (``fn`` by import path; a module-level function). ``threads`` > 0 sets
    each process's torch threads. Raises if a rank fails or the group does
    not finish within ``timeout`` seconds; every process is stopped
    before this returns."""
    import multiprocessing as mp
    import queue
    import time

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    address = f"tcp://localhost:{free_port()}"
    procs = [ctx.Process(target=_spawned, args=(fn, r, nprocs, address, threads, out, args),
                         daemon=True)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(results) < nprocs and not errors:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                # a process that died before it could report fails the group now
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)}
                if dead:
                    errors.append(f"ranks died before reporting (exit codes {dead})")
                elif time.monotonic() > deadline:
                    errors.append(f"the group did not finish within {timeout} s")
                continue
            if ok:
                results[rank] = pickle.loads(value)
            else:
                errors.append(f"rank {rank}: {value}")
    finally:
        for p in procs:
            p.join(timeout=5 if errors else 60)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    if errors:
        raise RuntimeError("spawn_local: " + "; ".join(errors))
    return [results[r] for r in range(nprocs)]

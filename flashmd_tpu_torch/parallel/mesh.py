"""Replica sharding of the batch over several GPUs (port of
flashmd_tpu/parallel/mesh.py), in PyTorch's idiom: one process per GPU,
joined by ``torch.distributed``.

The batch (molecule x replica) axis is the only one sharded, as in the JAX
package. Every process attaches the whole batch from the same inputs and
seed; a :class:`ReplicaMesh` then gives each rank the contiguous rows
``[rank S / n, (rank + 1) S / n)`` of every batch-leading tensor, and
everything else stays the same on every rank. Trajectories need no
communication between save points. The collectives are: the save points'
frames and the checkpoints, all-gathered so that every rank holds the
whole batch (its guards see every molecule and rank 0 writes whole
files); the batch-wide scalars of the guards, reduced; and parallel
tempering's exchange, which all-gathers the potentials and moves every
replica to the rank that owns its new slot.

Launch one process per GPU with ``torchrun --nproc_per_node=N`` and
:func:`initialize_distributed` joins them. The backend is NCCL where
CUDA is present and gloo otherwise, unless the caller states one; it is
never a fallback taken after a failure. Model parallelism stays out of
scope, as in the JAX package: the network is far smaller than one card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Union

import torch
import torch.distributed as dist

REPLICA_AXIS = "replica"


def _multihost_environment() -> bool:
    """True when the environment shows MORE THAN ONE process, or a launcher
    that expects a process group whatever the count (reference
    mesh.py:36-62, with torchrun's variables added). A lone
    coordinator-style variable is not enough: single-node SLURM jobs export
    ``SLURM_JOB_ID``, single-worker TPU VMs ``TPU_WORKER_HOSTNAMES``."""
    hosts = os.environ.get("TPU_WORKER_HOSTNAMES", "")
    if len([h for h in hosts.split(",") if h.strip()]) > 1:
        return True
    for var in ("WORLD_SIZE", "SLURM_NTASKS", "SLURM_NPROCS",
                "OMPI_COMM_WORLD_SIZE", "JAX_NUM_PROCESSES",
                "NUM_PROCESSES"):
        try:
            if int(os.environ.get(var, "")) > 1:
                return True
        except ValueError:
            pass
    # A coordinator address and this process's rank: torchrun (and the
    # JAX package's launchers) expect an init whatever the world's size.
    return bool(
        (os.environ.get("MASTER_ADDR") and os.environ.get("RANK"))
        or (os.environ.get("JAX_COORDINATOR_ADDRESS")
            and os.environ.get("JAX_PROCESS_ID"))
    )


def initialize_distributed(**kwargs) -> bool:
    """Join the process group; True if one is initialized.

    Without kwargs and without an environment that shows a launcher or
    more than one process, this is a no-op returning False. Otherwise
    ``torch.distributed.init_process_group(**kwargs)`` runs (``init_method``
    defaults to torchrun's ``env://``: ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``), and its failures PROPAGATE: a misconfigured
    job must die rather than run each process on the whole batch. The
    backend is ``kwargs["backend"]`` where given, else NCCL where CUDA is
    present and gloo otherwise; under NCCL this process takes the card
    ``LOCAL_RANK``."""
    if dist.is_initialized():
        return True
    if not kwargs and not _multihost_environment():
        return False
    kwargs.setdefault("backend",
                      "nccl" if torch.cuda.is_available() else "gloo")
    if kwargs["backend"] == "nccl":
        torch.cuda.set_device(_local_device_index())
    dist.init_process_group(**kwargs)
    return True


def _local_device_index() -> int:
    local = int(os.environ.get("LOCAL_RANK", "0"))
    count = torch.cuda.device_count()
    return local % count if count else local


@dataclasses.dataclass(frozen=True)
class ReplicaMesh:
    """The ranks that share one batch: ``size`` processes, this one
    ``rank`` of them, on ``device``. ``group`` is their process group
    (None for a single process without one)."""

    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None

    @property
    def distributed(self) -> bool:
        return self.group is not None

    def rows(self, n_sims: int) -> slice:
        """This rank's rows of an [n_sims, ...] batch."""
        if n_sims % self.size != 0:
            raise ValueError(
                f"Batch size {n_sims} is not divisible by the mesh size "
                f"{self.size}; pad the batch."
            )
        n = n_sims // self.size
        return slice(self.rank * n, (self.rank + 1) * n)


def make_replica_mesh(n_devices: Optional[int] = None,
                      device: Union[str, torch.device, None] = None
                      ) -> ReplicaMesh:
    """The mesh over the first ``n_devices`` ranks of the process group
    (every rank when None); a single process without a group is a mesh of
    one. ``device`` defaults to this rank's card (``cuda:LOCAL_RANK``)
    where CUDA is present, else the CPU. A request for more
    ranks than the world holds, or a call from a rank outside the first
    ``n_devices``, raises ValueError."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(
            f"A mesh of {n} ranks was requested but the world holds "
            f"{world}; launch {n} processes (torchrun --nproc_per_node={n})."
        )
    group = None
    if dist.is_initialized():
        group = (dist.group.WORLD if n == world
                 else dist.new_group(ranks=list(range(n))))
    if rank >= n:
        raise ValueError(
            f"Rank {rank} is outside the mesh of the first {n} of {world} "
            f"ranks; launch {n} processes."
        )
    if device is None:
        device = (torch.device("cuda", _local_device_index())
                  if torch.cuda.is_available() else torch.device("cpu"))
    return ReplicaMesh(rank=rank, size=n, device=torch.device(device),
                       group=group)


def as_mesh(option) -> Optional[ReplicaMesh]:
    """A mesh from the ``mesh`` option (reference cli.py:415-427): None
    stays None, a :class:`ReplicaMesh` passes through untouched, ``auto``
    joins the process group (:func:`initialize_distributed`) and takes
    every rank, and ``N`` the first N ranks."""
    if option is None or isinstance(option, ReplicaMesh):
        return option
    initialize_distributed()
    if str(option).strip().lower() == "auto":
        return make_replica_mesh()
    return make_replica_mesh(int(option))


def batch_sharding(mesh: ReplicaMesh) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    """The placement of a batch-major [S, ...] tensor: this rank's rows."""
    return lambda x: x[mesh.rows(x.shape[0])]


def replicated(mesh: ReplicaMesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """The placement of everything else: the same on every rank."""
    return lambda x: x


def mesh_is_multiprocess(mesh: Optional[ReplicaMesh]) -> bool:
    """True if the mesh spans more than one process."""
    return mesh is not None and mesh.size > 1


def shard_carry(carry: Dict, mesh: ReplicaMesh) -> Dict:
    """An integrator carry placed on the mesh: every batch-leading leaf
    (first dimension that of ``carry["pos"]``; the neighbour list's
    tensors too, its source CSR built again for the rows) sliced to this
    rank's rows, everything else kept (reference shard_carry,
    mesh.py:102-146). Raises ValueError when the batch does not divide."""
    from ..ops.neighborlist import NeighborMatrix, permute_neighbor_matrix

    s = carry["pos"].shape[0]
    rows = mesh.rows(s)
    shard, repl = batch_sharding(mesh), replicated(mesh)

    def place(x):
        if isinstance(x, NeighborMatrix):
            return permute_neighbor_matrix(
                x, torch.arange(s, device=x.idx.device)[rows])
        if isinstance(x, torch.Tensor) and x.ndim >= 1 and x.shape[0] == s:
            return shard(x)
        return repl(x)

    return {k: place(v) for k, v in carry.items()}


def all_gather(x: torch.Tensor, mesh: Optional[ReplicaMesh],
               dim: int = 0) -> torch.Tensor:
    """The ranks' tensors concatenated along ``dim`` in rank order: the
    whole batch from each rank's rows. Bool tensors travel as uint8."""
    if mesh is None or not mesh.distributed:
        return x
    send = x.to(torch.uint8) if x.dtype == torch.bool else x
    send = send.contiguous()
    parts = [torch.empty_like(send) for _ in range(mesh.size)]
    dist.all_gather(parts, send, group=mesh.group)
    out = torch.cat(parts, dim=dim)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def gather_neighbor_matrix(nbr, mesh: Optional[ReplicaMesh]):
    """The batched neighbour list of the whole batch from each rank's
    rows: ``idx``, ``mask``, ``n_max`` and ``shifts`` all-gathered, the
    source CSR built again for the whole batch."""
    from ..ops.neighborlist import NeighborMatrix, source_csr

    if mesh is None or not mesh.distributed:
        return nbr
    idx, mask = all_gather(nbr.idx, mesh), all_gather(nbr.mask, mesh)
    offsets, slots = source_csr(idx, mask)
    return NeighborMatrix(
        idx=idx, mask=mask, n_max=all_gather(nbr.n_max, mesh),
        csr_offsets=offsets, csr_slots=slots,
        shifts=None if nbr.shifts is None else all_gather(nbr.shifts, mesh),
    )


_OPS = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
        "sum": dist.ReduceOp.SUM}


def all_reduce(x: torch.Tensor, mesh: Optional[ReplicaMesh],
               op: str) -> torch.Tensor:
    """``x`` reduced over the ranks with ``op`` ("max", "min", "sum"), the
    same value on every rank."""
    if mesh is None or not mesh.distributed:
        return x
    out = x.clone()
    dist.all_reduce(out, op=_OPS[op], group=mesh.group)
    return out


def barrier(mesh: Optional[ReplicaMesh]) -> None:
    """Return once every rank of the mesh has reached this point with its
    queued device work done."""
    if mesh is None or not mesh.distributed:
        return
    flag = torch.zeros(1, device=mesh.device)
    dist.all_reduce(flag, group=mesh.group)
    if flag.is_cuda:
        torch.cuda.synchronize(flag.device)


def fetch_to_host(tree, mesh: Optional[ReplicaMesh] = None):
    """A tensor, or a dict of tensors, as numpy with every rank holding the
    whole batch (reference fetch_to_host, mesh.py:149-171): each tensor of
    one dimension or more is this rank's rows of a batch-leading value and
    is all-gathered along its first axis; a 0-dim tensor is the same on
    every rank and is copied as it is."""
    def fetch(x):
        if x.ndim >= 1:
            x = all_gather(x, mesh)
        return x.detach().cpu().numpy()

    if isinstance(tree, torch.Tensor):
        return fetch(tree)
    return {k: fetch(v) for k, v in tree.items()}


def is_io_process() -> bool:
    """True on the process that owns file IO (trajectories, checkpoints,
    the config echo): rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0

"""The device mesh over ``torch.distributed`` (counterpart of
diffmining_tpu/parallel/mesh.py).

JAX builds a ``Mesh`` over every device it sees, several a process, and
shards arrays over its "dp" axis. Here one process drives one device: the
mesh's devices are the ranks of the process group (NCCL between GPUs, gloo
on the CPU), and a rank takes its contiguous rows of a batch that every
rank forms alike. Nothing is gathered for the typicality sweep: each rank
writes the artifacts of its own rows. Where every rank needs the whole
result (the DIFT ensemble's mean, the dense search's best scores), the
ranks combine their rows with ``all_reduce_sum`` or ``all_gather_rows``,
the collectives XLA inserts in the JAX package; rank 0 is then the one
writer of what they share.

Every rank loads the same pipeline dir, or draws the same seed, so the
weights are already replicated; JAX's fsdp axis, ``fsdp_sharding``,
``shard_params`` and ``replicate_global`` belong to the trainer over fsdp
and are not ported.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# a lost peer fails the run after this long instead of hanging it
GROUP_TIMEOUT = datetime.timedelta(minutes=5)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A dp axis over the ranks of the process group: rank ``r < dp`` takes
    the ``r``-th share of a batch, a rank at or past ``dp`` none."""

    dp: int
    rank: int
    world: int


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_mesh(dp: Optional[int] = None) -> Mesh:
    """The mesh over the process group's ranks (JAX ``make_mesh`` with
    fsdp 1): ``dp`` defaults to the world size. Without a process group the
    mesh is this process alone."""
    world, rank = (dist.get_world_size(), dist.get_rank()) if _group_up() else (1, 0)
    if dp is None:
        dp = world
    if dp > 1 and not _group_up():
        raise ValueError(
            f"a mesh of dp={dp} needs one process a device: launch with "
            f"`torchrun --nproc_per_node {dp} ... --distributed` (or give --coordinator_address, "
            "--num_processes and --process_id)"
        )
    if dp > world:
        raise ValueError(f"mesh dp={dp} > {world} devices")
    return Mesh(dp=dp, rank=rank, world=world)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _local_rank(process_id: int) -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_id % max(torch.cuda.device_count(), 1)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> None:
    """Join the process group (JAX ``initialize_distributed``). With an
    address ``host:port`` the group rendezvous there with ``num_processes``
    ranks, this one ``process_id``; without, torchrun's environment
    (``env://``) says all three. NCCL for CUDA, gloo for the CPU. On CUDA
    the rank takes its own card
    (``LOCAL_RANK``, else ``process_id`` modulo the cards), so ``"cuda"``
    means that card from here on. A no-op when a group is already up."""
    if _group_up():
        return
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is None:
        if "RANK" not in os.environ:
            raise RuntimeError(
                "no process group to join: launch under `torchrun --nproc_per_node N` or give "
                "--coordinator_address host:port with --num_processes and --process_id"
            )
        rank, kwargs = int(os.environ["RANK"]), dict(init_method="env://")
    else:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator_address needs --num_processes and --process_id")
        rank = process_id
        kwargs = dict(init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(_local_rank(rank))
        # bound to the rank's card, not guessed from the rank
        kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, timeout=GROUP_TIMEOUT, **kwargs)


def host_local_batch_slice(global_batch: int, mesh: Mesh) -> slice:
    """The rows of a batch that every rank forms alike which this rank
    computes (JAX ``host_local_batch_slice``, with the mesh's rank in place
    of the process index); empty for a rank outside the mesh."""
    assert global_batch % mesh.dp == 0, f"global batch {global_batch} must divide by dp {mesh.dp}"
    per_rank = global_batch // mesh.dp
    if mesh.rank >= mesh.dp:
        return slice(0, 0)
    start = mesh.rank * per_rank
    return slice(start, start + per_rank)


def collective_rows(n: int, mesh: Optional[Mesh]) -> slice:
    """The rows of ``n`` that this rank computes for a collective: its
    ``host_local_batch_slice`` (all of them without a mesh). A rank outside
    the mesh computes rank 0's share, so that its call has its peers'
    shapes; ``all_reduce_sum`` zeroes it and ``all_gather_rows`` drops it."""
    if mesh is None:
        return slice(0, n)
    return host_local_batch_slice(n, mesh if mesh.rank < mesh.dp else dataclasses.replace(mesh, rank=0))


def _joins(mesh: Optional[Mesh]) -> bool:
    # mesh None and a mesh without a process group (dp 1) are one path
    return mesh is not None and _group_up()


def _to_backend(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` where the group's backend takes it: the tensor's own
    device under NCCL (which raises for a host tensor), the host under
    gloo."""
    x = x.detach()
    return x.clone() if dist.get_backend() == "nccl" else x.to("cpu", copy=True)


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``x`` over every rank of the group, the same on each, on
    ``x``'s device; a rank outside the mesh adds zeros but joins the call.
    Without a mesh or a process group, ``x`` itself."""
    if not _joins(mesh):
        return x
    t = _to_backend(x)
    if mesh.rank >= mesh.dp:
        t.zero_()
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.to(x.device)


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every mesh rank's rows of ``x`` (a leading axis, the same shape on
    every rank) concatenated in rank order, the same on each rank, on
    ``x``'s device; a rank outside the mesh joins the call and its rows are
    dropped. Without a mesh or a process group, ``x`` itself."""
    if not _joins(mesh):
        return x
    t = _to_backend(x).contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts[: mesh.dp]).to(x.device)


def is_writer(mesh: Optional[Mesh]) -> bool:
    """Whether this rank writes what the ranks share: rank 0, or the one
    process without a mesh."""
    return mesh is None or mesh.rank == 0


def cli_mesh(command: str, mesh_dp: Optional[int], device, distributed: Optional[bool] = None,
             coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
             process_id: Optional[int] = None) -> Optional[Mesh]:
    """A command's mesh from its ``--mesh_dp``. A command with no
    ``--distributed`` flag (``distributed`` None; JAX's have only
    ``--mesh_dp``) joins the process group under torchrun's environment
    (``RANK`` set), NCCL even for a group of one, and outside it refuses
    ``--mesh_dp`` > 1, naming torchrun. With the flags (typicality), it
    joins when asked, and ``make_mesh`` refuses dp > 1 outside a group.
    Once joined, ``--mesh_dp`` defaults to every rank. No mesh without
    ``--mesh_dp`` or a group."""
    joins = "RANK" in os.environ if distributed is None else distributed or coordinator_address is not None
    if joins:
        initialize_distributed(coordinator_address, num_processes, process_id, device=device)
        if mesh_dp is None:
            mesh_dp = dist.get_world_size()
    elif distributed is None and mesh_dp is not None and mesh_dp > 1:
        raise SystemExit(
            f"{command} --mesh_dp {mesh_dp} runs one process a GPU (ROADMAP A12): launch it as "
            f"`torchrun --nproc_per_node {mesh_dp} -m diffmining_tpu_torch {command} ... --mesh_dp {mesh_dp}`"
        )
    return make_mesh(dp=mesh_dp) if mesh_dp is not None else None


def host_barrier(name: str) -> None:
    """Align every rank here (JAX ``host_barrier``, which keys its barrier by
    ``name``; torch's takes none); a no-op without a process group. The
    group's timeout bounds the wait."""
    if _group_up():
        dist.barrier()


def destroy() -> None:
    """Leave the process group, if one is up."""
    if _group_up():
        dist.destroy_process_group()

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

The mesh has JAX's two axes, dp and fsdp: rank ``r`` sits at dp index
``r // fsdp`` and fsdp index ``r % fsdp``, and fsdp peers (one dp index)
take the same rows. Only the trainer asks for fsdp > 1. Every rank loads the
same pipeline dir, or draws the same seed, so the weights are replicated
from the start (JAX's ``replicate_global`` has no counterpart); under fsdp
the trainer shards its optimizer state and its EMA in ``FlatShards``'s flat
layout, the port's counterpart of JAX's ``fsdp_sharding`` and
``shard_params``, and keeps the weights whole.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

# a lost peer fails the run after this long instead of hanging it
GROUP_TIMEOUT = datetime.timedelta(minutes=5)
# the gradient all-reduce's flat buckets (a larger tensor is a bucket alone)
BUCKET_BYTES = 64 << 20
# FlatShards pads each tensor to a multiple of this times fsdp, so that a
# shard holds whole blocks of 8-bit Adam (ops/optim8bit.py _BLOCK)
SHARD_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class Mesh:
    """dp x fsdp over the ranks of the process group (JAX's devices
    reshaped to (dp, fsdp)): rank ``r < dp * fsdp`` takes the
    ``r // fsdp``-th share of a batch, which its fsdp peers take too; a rank
    at or past ``dp * fsdp`` takes none."""

    dp: int
    rank: int
    world: int
    fsdp: int = 1

    @property
    def dp_rank(self) -> int:
        return self.rank // self.fsdp

    @property
    def fsdp_rank(self) -> int:
        return self.rank % self.fsdp

    @property
    def outside(self) -> bool:
        return self.rank >= self.dp * self.fsdp


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_mesh(dp: Optional[int] = None, fsdp: int = 1) -> Mesh:
    """The mesh over the process group's ranks (JAX ``make_mesh``): ``dp``
    defaults to the world size over ``fsdp``. Without a process group the
    mesh is this process alone."""
    world, rank = (dist.get_world_size(), dist.get_rank()) if _group_up() else (1, 0)
    if dp is None:
        dp = max(world // fsdp, 1)
    if dp * fsdp > 1 and not _group_up():
        raise ValueError(
            f"a mesh of dp={dp} x fsdp={fsdp} needs one process a device: launch with "
            f"`torchrun --nproc_per_node {dp * fsdp} ... --distributed` (or give --coordinator_address, "
            "--num_processes and --process_id)"
        )
    if dp * fsdp > world:
        raise ValueError(f"mesh {dp}x{fsdp} > {world} devices")
    return Mesh(dp=dp, rank=rank, world=world, fsdp=fsdp)


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
    computes (JAX ``host_local_batch_slice``, with the mesh's dp index in
    place of the process index: the rows ``P("dp")`` puts on this rank's
    device); empty for a rank outside the mesh."""
    assert global_batch % mesh.dp == 0, f"global batch {global_batch} must divide by dp {mesh.dp}"
    per_rank = global_batch // mesh.dp
    if mesh.outside:
        return slice(0, 0)
    start = mesh.dp_rank * per_rank
    return slice(start, start + per_rank)


def collective_rows(n: int, mesh: Optional[Mesh]) -> slice:
    """The rows of ``n`` that this rank computes for a collective: its
    ``host_local_batch_slice`` (all of them without a mesh). A rank outside
    the mesh computes rank 0's share, so that its call has its peers'
    shapes; ``all_reduce_sum`` zeroes it and ``all_gather_rows`` drops it."""
    if mesh is None:
        return slice(0, n)
    return host_local_batch_slice(n, dataclasses.replace(mesh, rank=0) if mesh.outside else mesh)


def _joins(mesh: Optional[Mesh]) -> bool:
    # mesh None and a mesh without a process group (dp 1) are one path
    return mesh is not None and _group_up()


def _backend_device(x: torch.Tensor) -> torch.device:
    """Where the group's backend takes ``x``: the tensor's own device under
    NCCL (which raises for a host tensor), the host under gloo."""
    return x.device if dist.get_backend() == "nccl" else torch.device("cpu")


def _to_backend(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` where the group's backend takes it."""
    return x.detach().to(_backend_device(x), copy=True)


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``x`` over the mesh's dp shares, the same on every rank,
    on ``x``'s device: an fsdp peer past the first (the same rows) and a
    rank outside the mesh add zeros but join the call. Without a mesh or a
    process group, ``x`` itself."""
    if not _joins(mesh):
        return x
    t = _to_backend(x)
    if mesh.outside or mesh.fsdp_rank:
        t.zero_()
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.to(x.device)


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every dp share's rows of ``x`` (a leading axis, the same shape on
    every rank) concatenated in dp order, the same on each rank, on ``x``'s
    device: the first fsdp peer's rows of each share; every rank joins the
    call. Without a mesh or a process group, ``x`` itself."""
    if not _joins(mesh):
        return x
    t = _to_backend(x).contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts[: mesh.dp * mesh.fsdp: mesh.fsdp]).to(x.device)


def _buckets(sizes: Sequence[int], limit: int = BUCKET_BYTES) -> List[range]:
    """Consecutive runs of the indices of ``sizes`` (bytes), at most
    ``limit`` bytes a run unless one alone is larger."""
    runs, start, total = [], 0, 0
    for i, n in enumerate(sizes):
        if i > start and total + n > limit:
            runs.append(range(start, i))
            start, total = i, 0
        total += n
    if len(sizes) > start:
        runs.append(range(start, len(sizes)))
    return runs


def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Each of ``tensors`` (contiguous, of one dtype and device, the same
    shapes on every rank) replaced in place by the mean of its values over
    every rank of the group: flat buckets of about ``BUCKET_BYTES``, each
    summed in place by one all-reduce and divided by the world size, so at
    most one bucket lies beside the tensors (a host copy of it under gloo).
    It is the trainer's gradient all-reduce, which XLA adds for a batch over
    ``P("dp")``: fsdp peers hold the same rows, so the mean over the world
    is the mean over dp. A no-op without a mesh or a process group."""
    if not _joins(mesh) or not tensors:
        return
    world = dist.get_world_size()
    for run in _buckets([t.numel() * t.element_size() for t in tensors]):
        srcs = [tensors[i].detach().view(-1) for i in run]
        flat = torch.cat(srcs)
        t = flat.to(_backend_device(flat))
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        t.div_(world)
        if t is not flat:
            flat.copy_(t)
        torch._foreach_copy_(srcs, list(flat.split([x.numel() for x in srcs])))


def fsdp_group(mesh: Mesh):
    """The process group of this rank's fsdp peers (its dp index). Every
    rank creates every dp index's group, in the same order, as
    ``dist.new_group`` requires."""
    mine = None
    for d in range(mesh.dp):
        group = dist.new_group(list(range(d * mesh.fsdp, (d + 1) * mesh.fsdp)))
        if d == mesh.dp_rank:
            mine = group
    return mine


class FlatShards:
    """The fsdp layout of a list of tensors, flat and not by axis: each
    tensor is flattened and padded to a multiple of ``SHARD_BLOCK * fsdp``
    elements, of which fsdp index f owns the contiguous range
    ``[f m, (f + 1) m)``, m the padded size over fsdp. A rank's piece of a
    tensor is the real elements of its range (empty where the range lies in
    the padding).

    JAX's layout differs: ``fsdp_sharding`` (parallel/mesh.py:45-60) shards
    the largest axis that fsdp divides, replicates a tensor with none, and
    XLA gathers the axis where a computation needs it. The flat layout
    shards every tensor evenly, and a piece starts on a multiple of 256
    elements, so 8-bit Adam's per-tensor 256-element blocks
    (ops/optim8bit.py) fall whole inside one piece: they are the blocks of
    the unsharded tensor, and the update on a piece gives the unsharded
    update's bits. The trainer keeps the weights whole on every rank and
    shards what only the update reads, the optimizer state and the EMA;
    ``gather_`` makes the weights whole again after each update. At fsdp 1
    a piece is the tensor itself and nothing is gathered."""

    def __init__(self, mesh: Optional[Mesh], numels: Sequence[int]):
        self.fsdp = 1 if mesh is None else mesh.fsdp
        self.index = 0 if mesh is None else mesh.fsdp_rank
        self.numels = list(numels)
        self.chunks = [pad_to_multiple(n, SHARD_BLOCK * self.fsdp) // self.fsdp for n in self.numels]
        self.group = fsdp_group(mesh) if self.fsdp > 1 else None

    def _span(self, i: int, blocks: bool):
        """Tensor i's rows a rank and rows in all: flat elements, or with
        ``blocks`` 256-element blocks."""
        if blocks:
            return self.chunks[i] // SHARD_BLOCK, -(-self.numels[i] // SHARD_BLOCK)
        return self.chunks[i], self.numels[i]

    def rows(self, i: int, blocks: bool = False, index: Optional[int] = None) -> slice:
        """Fsdp rank ``index``'s (this rank's) range of tensor i: flat
        elements, or with ``blocks`` rows of 256-element blocks."""
        chunk, total = self._span(i, blocks)
        f = self.index if index is None else index
        return slice(min(f * chunk, total), min((f + 1) * chunk, total))

    def pieces(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's piece of each tensor, a view of its flat elements; at
        fsdp 1 the list itself."""
        if self.fsdp == 1:
            return tensors
        return [t.detach().view(-1)[self.rows(i)] for i, t in enumerate(tensors)]

    def take_(self, tensors: List[torch.Tensor]) -> None:
        """Each entry of ``tensors`` replaced by a copy of this rank's piece,
        so that a whole tensor's memory goes back as its entry is replaced;
        a no-op at fsdp 1."""
        if self.fsdp > 1:
            for i, t in enumerate(tensors):
                tensors[i] = t.view(-1)[self.rows(i)].clone()

    def gather(self, piece: torch.Tensor, i: int, blocks: bool = False) -> torch.Tensor:
        """Tensor i whole (flat elements, or with ``blocks`` its rows of
        blocks) from every fsdp peer's piece; every peer joins. On the
        backend's device (the host under gloo)."""
        chunk, total = self._span(i, blocks)
        dev = _backend_device(piece)
        buf = torch.zeros((chunk, *piece.shape[1:]), dtype=piece.dtype, device=dev)
        buf[: piece.shape[0]] = piece
        out = torch.empty((self.fsdp * chunk, *piece.shape[1:]), dtype=piece.dtype, device=dev)
        dist.all_gather_into_tensor(out, buf, group=self.group)
        return out[:total]

    def whole(self, pieces: List[torch.Tensor], shapes: Sequence[torch.Size], device=None,
              keep: bool = True) -> List[Optional[torch.Tensor]]:
        """Each tensor whole and of its shape, gathered one at a time and
        moved to ``device`` (the piece's by default; with the host, the
        card holds one whole tensor at a time); ``keep`` False joins the
        gathers and keeps nothing. At fsdp 1 the pieces themselves."""
        if self.fsdp == 1:
            return list(pieces)
        out = []
        for i, (p, shape) in enumerate(zip(pieces, shapes)):
            w = self.gather(p, i)
            out.append(w.view(shape).to(device or p.device) if keep else None)
        return out

    def gather_(self, tensors: List[torch.Tensor]) -> None:
        """Every tensor (contiguous, of one dtype and device) made whole in
        place from the fsdp peers' pieces, of which each rank's own is the
        newest: one all-gather a bucket of about ``BUCKET_BYTES``. A no-op at
        fsdp 1."""
        if self.fsdp == 1:
            return
        for run in _buckets([self.chunks[i] * tensors[i].element_size() for i in range(len(tensors))]):
            flats = [tensors[i].detach().view(-1) for i in run]
            offsets = [0]
            for i in run:
                offsets.append(offsets[-1] + self.chunks[i])
            buf = flats[0].new_zeros(offsets[-1])
            spans = [self.rows(i) for i in run]
            torch._foreach_copy_([buf[o:o + r.stop - r.start] for o, r in zip(offsets, spans)],
                                 [f[r] for f, r in zip(flats, spans)])
            dev = _backend_device(buf)
            out = torch.empty(self.fsdp * offsets[-1], dtype=buf.dtype, device=dev)
            dist.all_gather_into_tensor(out, buf.to(dev), group=self.group)
            out = out.to(buf.device).view(self.fsdp, offsets[-1])
            dst, src = [], []
            for f in range(self.fsdp):
                for j, i in enumerate(run):
                    r = self.rows(i, index=f)
                    dst.append(flats[j][r])
                    src.append(out[f, offsets[j]:offsets[j] + r.stop - r.start])
            torch._foreach_copy_(dst, src)


def shard_params(mesh: Optional[Mesh], tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """This rank's pieces of ``tensors`` in ``FlatShards``'s layout (views),
    the port's counterpart of JAX's ``shard_params``; the tensors
    themselves without fsdp."""
    return FlatShards(mesh, [t.numel() for t in tensors]).pieces(tensors)


def is_writer(mesh: Optional[Mesh]) -> bool:
    """Whether this rank writes what the ranks share: rank 0, or the one
    process without a mesh."""
    return mesh is None or mesh.rank == 0


def cli_mesh(command: str, mesh_dp: Optional[int], device, distributed: Optional[bool] = None,
             coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
             process_id: Optional[int] = None, mesh_fsdp: int = 1,
             batch: Optional[int] = None) -> Optional[Mesh]:
    """A command's mesh from its ``--mesh_dp`` (and the trainer's
    ``--mesh_fsdp``). A command with no ``--distributed`` flag
    (``distributed`` None; JAX's have only ``--mesh_dp``) joins the process
    group under torchrun's environment (``RANK`` set), NCCL even for a group
    of one, and outside it refuses ``--mesh_dp`` > 1, naming torchrun. With
    the flags (typicality, the trainer), it joins when asked, and
    ``make_mesh`` refuses more than one rank outside a group. Once joined,
    ``--mesh_dp`` defaults to every rank over fsdp, or with ``batch`` (the
    trainer's global batch) to ``gcd(batch, world // fsdp)``, as JAX's
    trainer picks it (finetuning/base.py:89-93). No mesh without
    ``--mesh_dp``, ``--mesh_fsdp`` > 1 or a group."""
    joins = "RANK" in os.environ if distributed is None else distributed or coordinator_address is not None
    if joins:
        initialize_distributed(coordinator_address, num_processes, process_id, device=device)
        if mesh_dp is None:
            ranks = dist.get_world_size() // mesh_fsdp
            mesh_dp = ranks if batch is None else math.gcd(batch, ranks)
    elif distributed is None and mesh_dp is not None and mesh_dp > 1:
        raise SystemExit(
            f"{command} --mesh_dp {mesh_dp} runs one process a GPU (ROADMAP A12): launch it as "
            f"`torchrun --nproc_per_node {mesh_dp} -m diffmining_tpu_torch {command} ... --mesh_dp {mesh_dp}`"
        )
    if mesh_dp is None and mesh_fsdp == 1:
        return None
    return make_mesh(dp=mesh_dp, fsdp=mesh_fsdp)


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

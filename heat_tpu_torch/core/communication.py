"""Communication substrate over ``torch.distributed`` (heat_tpu
``core/communication.py``).

heat_tpu is one controller over a device mesh; the port is the original
Heat's process model: one process per card, started by ``torchrun`` or any
launcher that calls ``torch.distributed.init_process_group`` (NCCL on the
card, gloo on the CPU). Without a process group the world is one process
and every collective is the identity, emitting nothing.

The layout is heat_tpu's canonical ceil-chunk layout, copied exactly
(``chunk``/``counts_displs``/``lshape_map``, heat_tpu
``communication.py:172/:196/:207``): rank ``r`` owns rows
``[min(r*c, n), min((r+1)*c, n))`` with ``c = ceil(n / size)``, so the tail
ranks may own fewer rows or none. Unlike heat_tpu, a rank's shard is stored
unpadded.

Every collective counts its calls and payload bytes per kind in
``comm.stats`` — the port's stand-in for heat_tpu's HLO collective audit,
so rules such as "exactly one all-reduce per Lloyd step" stay testable.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import capture as _capture

__all__ = ["Communication", "Request", "TorchCommunication", "MeshAxisComm", "MeshGrid",
           "get_comm", "use_comm", "sanitize_comm", "distributed_init", "psum", "copy_to",
           "all_gather", "ring_shift", "ppermute", "all_to_all"]

_REDUCE_OPS = {"sum": "SUM", "prod": "PRODUCT", "min": "MIN", "max": "MAX"}


class _NoWire:
    """The wire of a step trace (:mod:`.fusion`): its tensors hold no data,
    so a collective sends nothing and leaves its buffers as they are; the
    shapes the caller builds around it are the real ones."""

    @staticmethod
    def all_reduce(*args, **kwargs) -> None:
        return None

    all_gather = all_to_all_single = broadcast = all_reduce

    @staticmethod
    def P2POp(*args, **kwargs) -> None:
        return None

    @staticmethod
    def batch_isend_irecv(ops) -> list:
        return []


_NO_WIRE = _NoWire()


class Request:
    """A completed-request handle (heat_tpu ``communication.py:52``): every
    collective of the port returns when its result is ready, so ``Wait``
    and ``Test`` exist for call sites written against MPI requests."""

    __slots__ = ("_value",)

    def __init__(self, value):
        self._value = value

    def Wait(self, status=None):
        return self._value

    wait = Wait

    def Test(self, status=None) -> bool:
        return True


class Communication:
    """Base class of the communicators (heat_tpu ``communication.py:79``)."""

    @staticmethod
    def is_distributed() -> bool:
        raise NotImplementedError()

    def chunk(self, shape, split, rank=None):
        raise NotImplementedError()


class TorchCommunication(Communication):
    """A process group plus the collectives and chunk arithmetic over it.

    Parameters
    ----------
    group : torch.distributed.ProcessGroup, optional
        Defaults to the world group (or a world of one process when no
        process group is initialized).
    """

    def __init__(self, group=None):
        self.group = group
        self.stats: Dict[str, Dict[str, int]] = {}
        self._joined = False

    # ------------------------------------------------------------------ #
    # identity                                                           #
    # ------------------------------------------------------------------ #
    @staticmethod
    def is_distributed() -> bool:
        return dist.is_available() and dist.is_initialized()

    @property
    def size(self) -> int:
        if not self.is_distributed():
            return 1
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        if not self.is_distributed():
            return 0
        return dist.get_rank(self.group)

    def __repr__(self) -> str:
        return f"TorchCommunication(size={self.size}, rank={self.rank})"

    # ------------------------------------------------------------------ #
    # chunking / layout (copied from heat_tpu)                           #
    # ------------------------------------------------------------------ #
    def chunk_size(self, n: int) -> int:
        """Rows per rank for a split axis of length ``n``: ``ceil(n/size)``."""
        return -(-n // self.size) if n > 0 else 0

    def padded_size(self, n: int) -> int:
        return self.chunk_size(n) * self.size if n > 0 else 0

    def chunk(self, shape, split, rank: Optional[int] = None):
        """``(offset, local_shape, slices)`` of ``rank``'s chunk (default: this
        process's rank) of a global ``shape`` split along ``split``."""
        if rank is None:
            rank = self.rank
        shape = tuple(int(s) for s in shape)
        if split is None:
            return 0, shape, tuple(slice(0, s) for s in shape)
        split = split % len(shape) if shape else 0
        n = shape[split]
        c = self.chunk_size(n)
        start = min(rank * c, n)
        stop = min((rank + 1) * c, n)
        lshape = list(shape)
        lshape[split] = stop - start
        slices = tuple(
            slice(start, stop) if i == split else slice(0, s) for i, s in enumerate(shape)
        )
        return start, tuple(lshape), slices

    def counts_displs(self, n: int):
        """Per-rank ``(counts, displacements)`` along a split axis of length ``n``."""
        c = self.chunk_size(n)
        counts = [max(0, min((r + 1) * c, n) - min(r * c, n)) for r in range(self.size)]
        displs = [min(r * c, n) for r in range(self.size)]
        return tuple(counts), tuple(displs)

    def lshape_map(self, shape, split) -> np.ndarray:
        """``(size, ndim)`` array of per-rank shard shapes."""
        shape = tuple(int(s) for s in shape)
        out = np.tile(np.asarray(shape, dtype=np.int64), (self.size, 1))
        if split is not None and len(shape) > 0:
            split = split % len(shape)
            counts, _ = self.counts_displs(shape[split])
            out[:, split] = counts
        return out

    # ------------------------------------------------------------------ #
    # collectives                                                        #
    # ------------------------------------------------------------------ #
    def _count(self, kind: str, nbytes: int, like: Optional[torch.Tensor] = None):
        """Count one collective of ``kind`` and return the wire to send it
        on: ``torch.distributed``, or, for a data-free tensor ``like`` of a
        step trace (:mod:`.capture`), a wire that sends nothing and counts
        nothing. While a program is captured the count goes to the capture's
        tally, which each replay counts."""
        if like is not None and _capture.abstract(like):
            return _NO_WIRE
        self._joined = True
        tally = _capture.tally()
        if tally is not None:
            tally["comm"].append((self, kind, int(nbytes)))
            return dist
        rec = self.stats.setdefault(kind, {"calls": 0, "bytes": 0})
        rec["calls"] += 1
        rec["bytes"] += int(nbytes)
        return dist

    def reset_stats(self) -> None:
        self.stats = {}

    def Allreduce(self, tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """In-place all-reduce (``sum``/``prod``/``min``/``max``); returns
        ``tensor``. A bool tensor travels as uint8 (``min`` is a logical
        and, ``max`` a logical or) and comes back as bool."""
        if self.size == 1:
            return tensor
        net = self._count("all_reduce", tensor.numel() * tensor.element_size(), tensor)
        wire = tensor.to(torch.uint8) if tensor.dtype == torch.bool else tensor
        # the wire is the buffer in memory order: a strided tensor (a LAPACK
        # factor is column-major) would mix its elements with other ranks'
        wire = wire.contiguous()
        net.all_reduce(wire, op=getattr(dist.ReduceOp, _REDUCE_OPS[op]), group=self.group)
        if wire is not tensor:
            tensor.copy_(wire)
        return tensor

    def _packed_allreduce_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """The collective of one dtype group of :func:`.fusion.packed_psum`:
        the flat buffer summed over the ranks (a bool buffer travels as
        uint8 and comes back as a logical or), counted as
        ``packed_all_reduce``."""
        net = self._count("packed_all_reduce", flat.numel() * flat.element_size(), flat)
        if flat.dtype == torch.bool:
            wire = flat.to(torch.uint8)
            net.all_reduce(wire, group=self.group)
            return wire.to(torch.bool)
        net.all_reduce(flat, group=self.group)
        return flat

    def Allgather(self, tensor: torch.Tensor, axis: int = 0,
                  counts: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Concatenate every rank's ``tensor`` along ``axis``. ``counts``
        gives each rank's length along ``axis`` when they differ (the
        ceil-chunk tail); shards are padded to the longest for the wire."""
        if self.size == 1:
            return tensor
        if counts is None:
            counts = [tensor.shape[axis]] * self.size
        width = max(counts)
        send = tensor
        if tensor.shape[axis] < width:
            pad_shape = list(tensor.shape)
            pad_shape[axis] = width - tensor.shape[axis]
            send = torch.cat([tensor, tensor.new_zeros(pad_shape)], dim=axis)
        send = send.contiguous()
        wire = _as_bytes(send)  # any dtype travels (gloo has no bfloat16)
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        net = self._count("all_gather", wire.numel(), wire)
        net.all_gather(parts, wire, group=self.group)
        parts = [p.view(send.dtype).view(send.shape) for p in parts]
        return torch.cat([p.narrow(axis, 0, c) for p, c in zip(parts, counts)], dim=axis)

    def Alltoall(self, tensor: torch.Tensor, split_axis: int, concat_axis: int,
                 concat_size: int) -> torch.Tensor:
        """Exchange blocks between all ranks in ONE ``all_to_all_single``
        (heat_tpu ``communication.py:278``/``:335``): ``tensor`` holds the
        whole ``split_axis``, which is cut by the ceil-chunk layout
        (:meth:`chunk`) into one block per rank; rank ``r`` receives block
        ``r`` of every rank and concatenates them along ``concat_axis`` in
        rank order. ``concat_size`` is the global length along
        ``concat_axis``, chunked the same way.

        Every send and receive count follows from :meth:`chunk` alone, so
        all ranks agree on them. The blocks travel as bytes of contiguous
        buffers (any dtype; NCCL wants contiguous buffers), the split axis
        moved to the front before the call and back after it."""
        if self.size == 1:
            return tensor
        split_axis %= tensor.ndim
        concat_axis %= tensor.ndim
        if split_axis == concat_axis:
            raise ValueError("split_axis and concat_axis must differ")
        send_counts, _ = self.counts_displs(tensor.shape[split_axis])
        recv_concat, _ = self.counts_displs(concat_size)
        front = tensor.movedim(split_axis, 0)
        ax = concat_axis + 1 if concat_axis < split_axis else concat_axis
        rest = list(front.shape[1:])
        mine = send_counts[self.rank]
        recv_shapes = []
        for c in recv_concat:
            shape = [mine] + rest
            shape[ax] = c
            recv_shapes.append(shape)
        itemsize = tensor.element_size()
        row = int(np.prod(rest)) * itemsize
        send = front.contiguous().reshape(-1).view(torch.uint8)
        recv_bytes = [int(np.prod(shape)) * itemsize for shape in recv_shapes]
        recv = torch.empty(sum(recv_bytes), dtype=torch.uint8, device=tensor.device)
        net = self._count("all_to_all", send.numel(), send)
        net.all_to_all_single(recv, send, output_split_sizes=recv_bytes,
                              input_split_sizes=[c * row for c in send_counts],
                              group=self.group)
        pieces = [p.view(tensor.dtype).view(shape)
                  for p, shape in zip(recv.split(recv_bytes), recv_shapes)]
        return torch.cat(pieces, dim=ax).movedim(0, split_axis)

    def Alltoallv(self, tensor: torch.Tensor, send_counts: Sequence[int],
                  recv_counts: Sequence[int]) -> torch.Tensor:
        """Exchange rows in ONE ``all_to_all_single`` whose counts the caller
        plans: this rank sends ``send_counts[d]`` consecutive rows of
        ``tensor`` to rank ``d`` (in rank order) and receives
        ``recv_counts[s]`` rows from rank ``s``, concatenated in rank order.
        Every rank's counts must agree with its peers'. Any dtype travels, as
        bytes; counted as ``all_to_all``."""
        if self.size == 1:
            return tensor
        rest = tuple(tensor.shape[1:])
        row = int(np.prod(rest, dtype=np.int64)) * tensor.element_size()
        send = tensor.contiguous().reshape(-1).view(torch.uint8)
        recv = torch.empty(int(sum(recv_counts)) * row, dtype=torch.uint8,
                           device=tensor.device)
        net = self._count("all_to_all", send.numel(), send)
        net.all_to_all_single(recv, send, output_split_sizes=[c * row for c in recv_counts],
                              input_split_sizes=[c * row for c in send_counts],
                              group=self.group)
        return recv.view(tensor.dtype).view((int(sum(recv_counts)),) + rest)

    def Exscan(self, tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Exclusive scan over ranks (heat_tpu ``communication.py:254``,
        ``:344``): rank ``r`` gets the ``sum`` (or ``prod``) of the
        ``tensor`` of ranks ``0 .. r-1``, the neutral element on rank 0.
        Neither gloo nor NCCL has a scan: it is ONE all-gather of every
        rank's ``tensor`` (all of one shape), folded locally, and counted
        as ``exscan``."""
        if op not in ("sum", "prod"):
            raise ValueError(f"Exscan takes 'sum' or 'prod', got {op!r}")
        if self.size == 1:
            return torch.zeros_like(tensor) if op == "sum" else torch.ones_like(tensor)
        send = tensor.contiguous().reshape(-1).view(torch.uint8)
        parts = [torch.empty_like(send) for _ in range(self.size)]
        net = self._count("exscan", send.numel(), send)
        net.all_gather(parts, send, group=self.group)
        lower = [p.view(tensor.dtype).view(tensor.shape) for p in parts[:self.rank]]
        if not lower:
            return torch.zeros_like(tensor) if op == "sum" else torch.ones_like(tensor)
        stacked = torch.stack(lower)
        if op == "sum":
            return stacked.sum(0, dtype=tensor.dtype)
        return stacked.prod(0, dtype=tensor.dtype)

    def Bcast(self, tensor: torch.Tensor, root: int) -> torch.Tensor:
        """Rank ``root``'s ``tensor`` on every rank (heat_tpu's tile reads,
        ``tiling.py``): the other ranks pass a tensor of the same shape and
        dtype to receive into. Any dtype travels, as bytes; counted as
        ``broadcast`` on every rank."""
        if self.size == 1:
            return tensor
        wire = _as_bytes(tensor)
        net = self._count("broadcast", wire.numel(), wire)
        net.broadcast(wire, self._peer(root), group=self.group)
        return wire.view(tensor.dtype).view(tensor.shape)

    def Barrier(self, failed: bool = False, device=None) -> bool:
        """Wait for every rank, and tell each whether any rank ``failed``:
        ONE all-reduce (max) of a one-element flag, counted as ``barrier``
        (the turns of a rank-ordered write, :mod:`.io`). ``device`` is where
        the flag lives (the card for NCCL). At world size 1 it emits
        nothing and returns ``failed``."""
        if self.size == 1:
            return failed
        flag = torch.tensor([int(failed)], dtype=torch.int32, device=device)
        net = self._count("barrier", flag.numel() * flag.element_size(), flag)
        net.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
        return bool(flag.item())

    def _peer(self, rank: int) -> int:
        return dist.get_global_rank(self.group, rank) if self.group is not None else rank

    def _join(self, like: torch.Tensor) -> None:
        """NCCL sets up a group's communicator in its first collective, which
        every rank must join, and a round of :meth:`Permute` may leave a rank
        idle (no pair, or only empty tensors): unless this communicator has
        run a collective already, the round is preceded by a barrier
        (counted as ``p2p_join``). gloo needs none."""
        if self._joined or _capture.abstract(like) or dist.get_backend(self.group) != "nccl":
            return
        self._count("p2p_join", 0)
        dist.barrier(group=self.group)

    def ring_step(self, tensor: torch.Tensor, width: Optional[int] = None,
                  shift: int = 1) -> torch.Tensor:
        """One systolic ring step: send ``tensor`` to rank+shift, receive the
        block of rank-shift — the communication skeleton of the cdist ring
        (heat_tpu ``spatial/distance.py:150``) and of the indexing rings
        (heat_tpu ``communication.py:289``); ``shift = -1`` runs the ring
        backwards (the transpose of a step). Every rank's block has one
        shape; with ``width`` given, a shorter (or empty) block is padded
        with zeros along axis 0 to ``width`` rows on the wire, and the
        received block has ``width`` rows. Any dtype travels, as bytes."""
        if self.size == 1:
            return tensor
        if width is not None and tensor.shape[0] < width:
            pad = tensor.new_zeros((width - tensor.shape[0],) + tuple(tensor.shape[1:]))
            tensor = torch.cat([tensor, pad])
        send = _as_bytes(tensor)
        recv = torch.empty_like(send)
        nxt = self._peer((self.rank + shift) % self.size)
        prv = self._peer((self.rank - shift) % self.size)
        net = self._count("ring_step", send.numel(), send)
        ops = [net.P2POp(dist.isend, send, nxt, self.group),
               net.P2POp(dist.irecv, recv, prv, self.group)]
        for req in net.batch_isend_irecv(ops):
            req.wait()
        return recv.view(tensor.dtype).view(tensor.shape)

    def Permute(self, tensor: torch.Tensor, pairs, recv_shape) -> Optional[torch.Tensor]:
        """One round of a partial permutation (heat_tpu's ``ppermute``,
        ``_manips.py:98``): for each ``(src, dst)`` of ``pairs`` rank
        ``src`` sends its ``tensor`` to rank ``dst``; no rank sends or
        receives twice. Returns the tensor this rank receives, of
        ``recv_shape`` and ``tensor``'s dtype (``tensor`` itself for a pair
        ``(r, r)``), or None. The round is posted as ONE
        ``batch_isend_irecv``; a rank that neither sends nor receives posts
        nothing, and no message of zero bytes is posted. Every rank counts
        the round as ``permute``, with the bytes it sends."""
        if self.size == 1:
            return tensor if (0, 0) in pairs else None
        me = self.rank
        dst = next((d for s, d in pairs if s == me), None)
        src = next((s for s, d in pairs if d == me), None)
        if len({d for _, d in pairs}) < len(pairs) or len({s for s, _ in pairs}) < len(pairs):
            raise ValueError(f"not a partial permutation: {pairs}")
        ops, recv, out = [], None, None
        sent = 0
        if dst is not None and dst != me and tensor.numel():
            send = _as_bytes(tensor)
            sent = send.numel()
            ops.append((dist.isend, send, self._peer(dst)))
        if src == me:
            out = tensor
        elif src is not None:
            out = torch.empty(tuple(recv_shape), dtype=tensor.dtype, device=tensor.device)
            if out.numel():
                recv = _as_bytes(out)
                ops.append((dist.irecv, recv, self._peer(src)))
        self._join(tensor)
        net = self._count("permute", sent, tensor)
        if ops:
            for req in net.batch_isend_irecv([net.P2POp(f, t, peer, self.group)
                                              for f, t, peer in ops]):
                req.wait()
        if recv is not None:
            out = recv.view(tensor.dtype).view(tuple(recv_shape))
        return out


def _as_bytes(tensor: torch.Tensor) -> torch.Tensor:
    """A contiguous copy-free (where possible) byte view of ``tensor``: bool
    and complex travel as bytes, as :meth:`TorchCommunication.Alltoall`
    sends them."""
    flat = tensor.contiguous().reshape(-1)
    if flat.numel() == 1:  # a one-element view may keep any stride
        flat = flat.as_strided((1,), (1,))
    return flat.view(torch.uint8)


class MeshAxisComm(TorchCommunication):
    """The communicator of one :class:`MeshGrid` axis, or of several axes
    together (heat_tpu ``communication.py:399``): its collectives run over
    the ranks that share this rank's coordinates on every other axis of the
    grid (one ``torch.distributed`` subgroup per such line), and ``size``
    and ``rank`` are the line's. Each view counts its own collectives in
    ``stats``."""

    def __init__(self, grid: "MeshGrid", axis_name: str, group, size: int, rank: int):
        super().__init__(group)
        self.grid = grid
        self.axis_name = axis_name
        self._size = size
        self._rank = rank

    @property
    def size(self) -> int:
        return self._size

    @property
    def rank(self) -> int:
        return self._rank

    def __repr__(self) -> str:
        return (f"MeshAxisComm(axis={self.axis_name!r}, size={self.size}, rank={self.rank}, "
                f"grid={self.grid.sizes})")


class MeshGrid:
    """A named N-D process grid for combined parallelism (heat_tpu
    ``communication.py:440``), e.g. ``MeshGrid((2, 1, 2, 1), ("dp", "pp",
    "tp", "sp"))`` for the transformer on four processes.

    The product of ``shape`` must equal the world size. Rank ``r`` sits at
    the grid coordinate ``np.unravel_index(r, shape)`` (row-major, heat_tpu's
    device order). Building a grid is collective: every rank creates the
    subgroup of every line of every axis above 1 and below the world size,
    in the same order (``dist.new_subgroups_by_enumeration``), and
    ``groups_created`` counts them apart from any collective's count; an
    axis as large as the world runs on the world group. :meth:`group` builds
    the communicator of several axes together on its first call, which every
    rank must make in the same order. ``device`` is where the grid's work
    runs: the card by default (this rank's card under ``torchrun``),
    ``"cpu"`` on request; it is resolved once, here, so threads that use the
    grid later see the same card.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str] = ("dp", "sp"),
                 device=None):
        from .devices import sanitize_device

        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} and axis_names {axis_names} length mismatch")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names must differ, got {axis_names}")
        if any(s < 1 for s in shape):
            raise ValueError(f"grid axes must be at least 1, got {shape}")
        want = int(np.prod(shape))
        world = get_comm()
        if want != world.size:
            raise ValueError(f"grid shape {shape} needs {want} processes, the world has "
                             f"{world.size}")
        self.shape = shape
        self.axis_names = axis_names
        self.rank = world.rank
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank, shape))
        self.device = sanitize_device(device)
        self.torch_device = self.device.torch_device
        self.groups_created = 0
        self._groups: Dict[tuple, MeshAxisComm] = {}
        self._axes = {name: self.group((name,)) for name in axis_names}

    @property
    def sizes(self) -> Dict[str, int]:
        """Axis name -> size (heat_tpu's ``grid.mesh.shape``)."""
        return dict(zip(self.axis_names, self.shape))

    def coord(self, name: str) -> int:
        """This rank's coordinate along axis ``name``."""
        return self.coords[self.axis_names.index(name)]

    def axis(self, name: str) -> MeshAxisComm:
        """The communicator view of one grid axis."""
        return self._axes[name]

    def group(self, names: Sequence[str]) -> MeshAxisComm:
        """The communicator over the axes ``names`` together (rank row-major
        over them), with every other coordinate fixed at this rank's: e.g.
        ``group(("dp", "sp"))``, the transformer's data axes. ``names`` must
        be in the grid's order: a ``torch.distributed`` group numbers its
        ranks in ascending world rank, which is this row-major order only
        then."""
        names = tuple(names)
        if names in self._groups:
            return self._groups[names]
        idx = [self.axis_names.index(n) for n in names]
        if idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(f"group axes {names} must be distinct and in the grid's order "
                             f"{self.axis_names}")
        sizes = [self.shape[i] for i in idx]
        size = int(np.prod(sizes))
        rank = int(np.ravel_multi_index([self.coords[i] for i in idx], sizes)) if idx else 0
        group = None
        if 1 < size < int(np.prod(self.shape)):
            ranks = np.arange(int(np.prod(self.shape))).reshape(self.shape)
            # the grid's other axes first, then ``names`` in their order
            rest = [i for i in range(len(self.shape)) if i not in idx]
            lines = ranks.transpose(rest + idx).reshape(-1, size)
            group, _ = dist.new_subgroups_by_enumeration([list(map(int, l)) for l in lines])
            self.groups_created += len(lines)
        comm = MeshAxisComm(self, "+".join(names), group, size, rank)
        self._groups[names] = comm
        return comm

    def stats(self) -> Dict[str, Dict[str, int]]:
        """Calls per collective kind, per axis view (``"dp+sp"`` for
        :meth:`group` views), leaving out views that ran none."""
        return {c.axis_name: {k: v["calls"] for k, v in c.stats.items()}
                for c in self._groups.values() if c.stats}

    def reset_stats(self) -> None:
        for c in self._groups.values():
            c.reset_stats()

    def __repr__(self) -> str:
        return f"MeshGrid({self.sizes})"


# --------------------------------------------------------------------------- #
# collectives with their transposes, for autograd                             #
# --------------------------------------------------------------------------- #
# heat_tpu differentiates its collectives by JAX's transposition rules under
# shard_map's replication typing; each pair below is one of those rules,
# written out: psum <-> the identity on a replicated cotangent, the identity
# on a replicated value <-> psum of its cotangents, a ring step or
# permutation <-> the reverse one, an all-to-all <-> the inverse all-to-all.


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        out = x.contiguous().clone()
        comm.Allreduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        ctx.comm.Allreduce(g)
        return g, None


def psum(x: torch.Tensor, comm: TorchCommunication) -> torch.Tensor:
    """The sum of ``x`` over ``comm``'s ranks, whose cotangent is the same
    on every rank and passes back unchanged (a ``psum`` whose result feeds
    replicated work: Megatron's row-parallel reduction). One all-reduce
    forward, none backward; the identity at size 1."""
    if comm.size == 1:
        return x
    return _Psum.apply(x, comm)


def copy_to(x: torch.Tensor, comm: TorchCommunication) -> torch.Tensor:
    """``x``, replicated over ``comm``, entering work that differs by rank:
    the identity forward, the sum of the ranks' cotangents backward (the
    transpose of heat_tpu's implicit ``pvary``). None forward, one
    all-reduce backward; the identity at size 1."""
    if comm.size == 1:
        return x
    return _CopyTo.apply(x, comm)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis, counts):
        ctx.comm, ctx.axis = comm, axis
        ctx.counts = counts or [x.shape[axis]] * comm.size
        return comm.Allgather(x.contiguous(), axis=axis, counts=counts)

    @staticmethod
    def backward(ctx, g):
        start = sum(ctx.counts[:ctx.comm.rank])
        return g.narrow(ctx.axis, start, ctx.counts[ctx.comm.rank]), None, None, None


def all_gather(x: torch.Tensor, comm: TorchCommunication, axis: int = 0,
               counts: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``axis`` (``counts``: each rank's
    length there, where they differ), feeding work done alike on every
    rank: its cotangent is the same on every rank, and each takes back its
    own part. One ``all_gather`` forward, none backward."""
    if comm.size == 1:
        return x
    return _GatherReplicated.apply(x, comm, axis % x.ndim, counts)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, shift, *tensors):
        ctx.comm, ctx.shift = comm, shift
        return tuple(comm.ring_step(t, shift=shift) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        back = tuple(None if g is None else ctx.comm.ring_step(g.contiguous(), shift=-ctx.shift)
                     for g in grads)
        return (None, None) + back


def ring_shift(comm: TorchCommunication, *tensors: torch.Tensor, shift: int = 1):
    """Each tensor moved one ring step (to rank + ``shift``), one
    ``ring_step`` apiece in the order given; the backward sends each
    cotangent the reverse step, in the same order, so every rank posts its
    messages alike. Returns a tuple."""
    if comm.size == 1:
        return tuple(tensors)
    return _RingShift.apply(comm, shift, *tensors)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, pairs):
        ctx.comm, ctx.pairs, ctx.shape = comm, pairs, x.shape
        return comm.Permute(x.contiguous(), pairs, x.shape)

    @staticmethod
    def backward(ctx, g):
        back = [(d, s) for s, d in ctx.pairs]
        return ctx.comm.Permute(g.contiguous(), back, ctx.shape), None, None


def ppermute(x: torch.Tensor, comm: TorchCommunication, pairs) -> torch.Tensor:
    """heat_tpu's ``lax.ppermute`` over a full permutation ``pairs`` of
    ``comm``'s ranks (every rank sends once and receives once, blocks of one
    shape): one ``permute`` round forward, the reverse round backward."""
    if comm.size == 1:
        return x
    return _Ppermute.apply(x, comm, tuple(pairs))


def _exchange(comm, x, split_axis: int, concat_axis: int, concat_size: int):
    if split_axis == concat_axis:  # blocks of rows: the rows' rank changes, not the axis
        front = x.movedim(split_axis, 0)
        n = front.shape[0] // comm.size
        out = comm.Alltoallv(front, [n] * comm.size, [n] * comm.size)
        return out.movedim(0, split_axis)
    return comm.Alltoall(x, split_axis, concat_axis, concat_size)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, split_axis, concat_axis):
        ctx.comm, ctx.axes = comm, (split_axis, concat_axis)
        ctx.split_size = x.shape[split_axis]
        return _exchange(comm, x, split_axis, concat_axis, x.shape[concat_axis] * comm.size)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        back = _exchange(ctx.comm, g.contiguous(), concat_axis, split_axis, ctx.split_size)
        return back, None, None, None


def all_to_all(x: torch.Tensor, comm: TorchCommunication, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """heat_tpu's tiled ``lax.all_to_all``: ``x``'s ``split_axis`` is cut
    into ``comm.size`` equal blocks, block ``r`` goes to rank ``r``, and the
    blocks received are concatenated along ``concat_axis`` in rank order
    (with ``split_axis == concat_axis``, heat_tpu's untiled exchange of the
    MoE buffers: the axis keeps its length and indexes the source rank's
    block). One ``all_to_all`` forward, the inverse one backward."""
    if comm.size == 1:
        return x
    if x.shape[split_axis] % comm.size:
        raise ValueError(f"all_to_all: axis {split_axis} of length {x.shape[split_axis]} does "
                         f"not split over {comm.size} ranks")
    return _AllToAll.apply(x, comm, split_axis % x.ndim, concat_axis % x.ndim)


_default_comm: Optional[TorchCommunication] = None


def get_comm() -> TorchCommunication:
    """The default communicator: the world group."""
    global _default_comm
    if _default_comm is None:
        _default_comm = TorchCommunication()
    return _default_comm


def use_comm(comm: TorchCommunication) -> None:
    """Set the default communicator."""
    global _default_comm
    if not isinstance(comm, TorchCommunication):
        raise TypeError(f"comm must be a TorchCommunication, got {type(comm)}")
    _default_comm = comm


def sanitize_comm(comm) -> TorchCommunication:
    """Validate-or-default a communicator."""
    if comm is None:
        return get_comm()
    if not isinstance(comm, TorchCommunication):
        raise TypeError(f"comm must be a TorchCommunication, got {type(comm)}")
    return comm


def distributed_init(backend: Optional[str] = None, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     **kwargs) -> TorchCommunication:
    """Start the process group and install the world communicator
    (heat_tpu ``communication.py:557``, which joins a pod with
    ``jax.distributed.initialize``).

    Under ``torchrun`` every argument may stay None: the world comes from
    its environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``; ``init_method="env://"``), the backend is NCCL when a card is
    visible and gloo otherwise, and each process takes the card
    ``LOCAL_RANK``. Elsewhere pass ``init_method`` (for instance
    ``"tcp://localhost:29500"``), ``world_size`` and ``rank``. ``kwargs``
    go to ``torch.distributed.init_process_group``. An initialized group is
    kept; without a launcher's environment (no ``RANK``) and without
    ``init_method``, none is started and the world is this one process.
    Returns the new default communicator."""
    import os

    launched = "RANK" in os.environ or init_method is not None
    if launched and not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if backend == "nccl" and "LOCAL_RANK" in os.environ:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        args = dict(kwargs)
        if world_size is not None:
            args["world_size"] = int(world_size)
        if rank is not None:
            args["rank"] = int(rank)
        dist.init_process_group(backend, init_method=init_method, **args)
    comm = TorchCommunication()
    use_comm(comm)
    return comm

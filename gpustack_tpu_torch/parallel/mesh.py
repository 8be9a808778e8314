"""Mesh plans and the per-process mesh of a multi-GPU replica.

The port of ``gpustack_tpu/parallel/mesh.py``. ``MeshPlan`` and
``plan_mesh`` are the JAX module's, with the same answers. Canonical axes,
outer to inner:

- ``dp``: data/replica parallelism (independent request batches);
- ``sp``: sequence/context parallelism (ring-attention prefill);
- ``ep``: expert parallelism (the MoE expert dimension);
- ``tp``: tensor parallelism (attention heads and FFN width).

Where JAX's ``make_mesh`` builds one ``Mesh`` of devices that XLA
partitions programs over, the port runs one process per GPU: :class:`Mesh`
is one rank's view, its (dp, sp, ep, tp) coordinates in JAX's outer to
inner order (``tp`` innermost, so a ``tp`` group is ranks that differ by
1) and the ``torch.distributed`` process groups its forward needs: the
``tp`` group (the attention and dense MLP all-reduces), the ``ep x tp``
group (an MoE layer's combine), the ``sp`` group (ranks that differ only
in their ``sp`` index: the ring's hops, the cache merge's all-reduces,
the prefill's last hidden row and the KV moves of ``insert``), the
``dp`` group (ranks that differ only in their ``dp`` index: the same
heads and experts over other slots' cache rows; a host-tier store's K/V
from the group that holds them) and the world (the sampled tokens'
broadcast, or under ``dp`` their gather, a draft's proposals, and the
first-token logits a ``dp`` group sends rank 0). A host-tier block is
cut into parts: a rank keeps its KV heads (:func:`kv_head_range`) of its
``sp`` stripe of the block's tokens (:func:`kv_stripe`), and a handed-off
block run moves point to point between rank 0 and the ranks that hold
its parts (:meth:`Mesh.gather_parts`, :meth:`Mesh.scatter_from_leader_`).
Collectives are NCCL on the card and gloo on the CPU; a group of one rank
makes each collective a no-op, so one process needs no process group at
all.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import socket
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

AXIS_DP = "dp"
AXIS_SP = "sp"
AXIS_EP = "ep"
AXIS_TP = "tp"
MESH_AXES = (AXIS_DP, AXIS_SP, AXIS_EP, AXIS_TP)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A concrete parallelism plan: axis sizes for one model replica.
    ``chips`` (the product) is the number of GPUs, one process each."""

    dp: int = 1
    sp: int = 1
    ep: int = 1
    tp: int = 1

    @property
    def chips(self) -> int:
        return self.dp * self.sp * self.ep * self.tp

    def axis_sizes(self) -> Dict[str, int]:
        return {
            AXIS_DP: self.dp,
            AXIS_SP: self.sp,
            AXIS_EP: self.ep,
            AXIS_TP: self.tp,
        }

    def __str__(self) -> str:
        return f"dp{self.dp}xsp{self.sp}xep{self.ep}xtp{self.tp}"

    @staticmethod
    def parse(s: str) -> "MeshPlan":
        """Parse 'dp2xsp1xep1xtp4' (any subset/order of axes)."""
        sizes = {"dp": 1, "sp": 1, "ep": 1, "tp": 1}
        for part in s.lower().split("x"):
            for ax in sizes:
                if part.startswith(ax):
                    sizes[ax] = int(part[len(ax):])
                    break
            else:
                raise ValueError(f"bad mesh plan component {part!r} in {s!r}")
        return MeshPlan(**sizes)


def _largest_pow2_divisor(n: int, cap: int) -> int:
    best = 1
    d = 1
    while d <= cap and n % d == 0:
        best = d
        d *= 2
    return best


def plan_mesh(
    n_devices: int,
    num_kv_heads: int,
    num_experts: int = 0,
    long_context: bool = False,
) -> MeshPlan:
    """Auto-parallelism: a mesh shape for ``n_devices`` GPUs (the JAX
    heuristic). MoE models give up to half the factor to ``ep``; ``tp``
    goes up to the KV-head count (under ``long_context`` up to half the
    rest, ``sp`` taking the other half); what is left goes to ``dp``."""
    if n_devices <= 0 or n_devices & (n_devices - 1):
        raise ValueError(f"device count must be a power of two, got {n_devices}")
    rest = n_devices
    ep = 1
    if num_experts:
        ep = _largest_pow2_divisor(num_experts, max(1, rest // 2))
        rest //= ep
    if long_context and rest >= 2:
        tp = _largest_pow2_divisor(num_kv_heads, rest // 2)
        return MeshPlan(dp=1, sp=rest // tp, ep=ep, tp=tp)
    tp = _largest_pow2_divisor(num_kv_heads, rest)
    return MeshPlan(dp=rest // tp, sp=1, ep=ep, tp=tp)


def free_port() -> int:
    """A TCP port free on this host now (the rendezvous and the command
    channel pick theirs so, never a fixed one)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_coords(plan: MeshPlan, rank: int) -> Dict[str, int]:
    """Rank ``rank``'s index along each axis: row-major over (dp, sp, ep,
    tp), where JAX's ``make_mesh`` puts device ``rank``."""
    idx, rest = [], rank
    for n in reversed([plan.dp, plan.sp, plan.ep, plan.tp]):
        idx.append(rest % n)
        rest //= n
    return dict(zip(MESH_AXES, reversed(idx)))


def kv_head_range(plan: MeshPlan, rank: int, kv_heads: int) -> Tuple[int, int]:
    """The KV heads ``[lo, hi)`` rank ``rank`` keeps, as the sharding cuts
    them (``sharding._slice``): its ``tp`` index's ``kv_heads / tp``, or,
    with ``tp`` above ``kv_heads``, the one whole head its query heads
    read."""
    t, tp = rank_coords(plan, rank)[AXIS_TP], plan.tp
    if tp > kv_heads:
        i = t // (tp // kv_heads)
        return i, i + 1
    n = kv_heads // tp
    return t * n, (t + 1) * n


def kv_stripe(plan: MeshPlan, rank: int,
              block_tokens: int) -> Tuple[int, int]:
    """The rows ``[lo, hi)`` of each host-tier block of ``block_tokens``
    tokens that rank ``rank`` keeps: at ``sp`` index ``i``, ``lo =
    floor(i·bt/sp)`` and ``hi = floor((i+1)·bt/sp)``, so the ``sp``
    ranks' stripes tile the block for any block size (``(0, bt)`` without
    ``sp``)."""
    i, sp = rank_coords(plan, rank)[AXIS_SP], plan.sp
    return i * block_tokens // sp, (i + 1) * block_tokens // sp


def rank_at(plan: MeshPlan, **coords: int) -> int:
    """The global rank at ``coords`` (each axis not named: index 0)."""
    rank = 0
    for ax in MESH_AXES:
        rank = rank * plan.axis_sizes()[ax] + coords.get(ax, 0)
    return rank


class Mesh:
    """One rank's place in a plan's mesh and its process groups.

    ``coords`` maps each axis to this rank's index along it; rank r sits
    at ``(dp, sp, ep, tp)`` of ``r`` in row-major order over the plan's
    axis sizes, as JAX's ``make_mesh`` reshapes its device list. Without
    an initialised process group the mesh must be a single rank."""

    def __init__(self, plan: MeshPlan, rank: int = 0):
        self.plan = plan
        self.rank = rank
        self.coords = rank_coords(plan, rank)
        self.tp_group = self.moe_group = self.world_group = None
        self.sp_group = self.dp_group = None
        if plan.chips > 1:
            if not dist.is_initialized():
                raise RuntimeError(
                    f"plan {plan} spans {plan.chips} ranks: initialise the "
                    "process group first (init_mesh)"
                )
            if dist.get_world_size() != plan.chips:
                raise ValueError(
                    f"plan {plan} needs {plan.chips} ranks, the process "
                    f"group has {dist.get_world_size()}"
                )
            self.world_group = dist.group.WORLD
            self.tp_group = self._groups(("tp",))
            self.moe_group = self._groups(("ep", "tp"))
            if plan.sp > 1:
                self.sp_group = self._groups(("sp",))
            if plan.dp > 1:
                self.dp_group = self._groups(("dp",))

    def _groups(self, axes):
        """This rank's group over ``axes``: the ranks whose coordinates
        differ from its own only along them. Every group is made on every
        rank in one order (``new_group`` is collective), and a group that
        is the whole world is the world group."""
        p = self.plan
        width = 1
        for ax in axes:
            width *= p.axis_sizes()[ax]
        if width == p.chips:
            return dist.group.WORLD
        members: Dict[tuple, List[int]] = {}
        for r in range(p.chips):
            c = rank_coords(p, r)
            members.setdefault(
                tuple(c[a] for a in MESH_AXES if a not in axes), []
            ).append(r)
        mine = None
        for ranks in members.values():
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = g
        return mine

    # ---- coordinates ------------------------------------------------------

    @property
    def tp(self) -> int:
        return self.plan.tp

    @property
    def tp_rank(self) -> int:
        return self.coords[AXIS_TP]

    @property
    def ep_rank(self) -> int:
        return self.coords[AXIS_EP]

    @property
    def sp(self) -> int:
        return self.plan.sp

    @property
    def sp_rank(self) -> int:
        return self.coords[AXIS_SP]

    def peer(self, axis: str, index: int) -> int:
        """The global rank at ``index`` along ``axis`` with this rank's
        other coordinates (point-to-point ops and a group's collectives
        name global ranks)."""
        return rank_at(self.plan, **dict(
            self.coords, **{axis: index % self.plan.axis_sizes()[axis]}))

    def sp_peer(self, sp_index: int) -> int:
        return self.peer(AXIS_SP, sp_index)

    @property
    def dp(self) -> int:
        return self.plan.dp

    @property
    def dp_rank(self) -> int:
        return self.coords[AXIS_DP]

    @property
    def group_size(self) -> int:
        """Ranks of one ``dp`` group (one copy of the model)."""
        return self.plan.chips // self.plan.dp

    def dp_leader(self, dp_index: int) -> int:
        """The first global rank of ``dp`` group ``dp_index``: rank 0's
        place in that group."""
        return dp_index * self.group_size

    @property
    def moe_size(self) -> int:
        return self.plan.ep * self.plan.tp

    @property
    def world(self) -> int:
        return self.plan.chips

    # ---- collectives (no-ops on a group of one) ---------------------------

    def all_reduce_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ``tp`` group, in place."""
        if self.tp > 1:
            dist.all_reduce(x, group=self.tp_group)
        return x

    def all_reduce_moe(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ``ep x tp`` group, in place."""
        if self.moe_size > 1:
            dist.all_reduce(x, group=self.moe_group)
        return x

    def all_gather_tp(self, x: torch.Tensor) -> torch.Tensor:
        """The ``tp`` ranks' ``x`` side by side along the last axis."""
        if self.tp == 1:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.tp)]
        dist.all_gather(parts, x, group=self.tp_group)
        return torch.cat(parts, dim=-1)

    def all_reduce_sp(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``x`` over the ``sp`` group in place: ``"sum"`` or
        ``"max"``."""
        if self.sp > 1:
            dist.all_reduce(
                x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                group=self.sp_group,
            )
        return x

    def broadcast_sp_(self, x: torch.Tensor, sp_src: int) -> torch.Tensor:
        """The ``x`` of the rank at ``sp_src`` along ``sp``, in place on
        every rank of this rank's ``sp`` group."""
        if self.sp > 1:
            dist.broadcast(x, src=self.sp_peer(sp_src), group=self.sp_group)
        return x

    def sp_p2p(self, sends, recvs) -> list:
        """Post ``sends`` ``[(tensor, sp_index)]`` and ``recvs``
        ``[(tensor, sp_index)]`` over the ``sp`` group as one batch (NCCL
        groups them, so no order of the pairs can deadlock); returns the
        requests to ``wait`` on. Every rank of the group computes the same
        plan, so each send meets its receive."""
        ops = [dist.P2POp(dist.isend, t, self.sp_peer(i), self.sp_group)
               for t, i in sends]
        ops += [dist.P2POp(dist.irecv, t, self.sp_peer(i), self.sp_group)
                for t, i in recvs]
        if not ops:
            return []
        device = ops[0].tensor.device
        if device.type != "cuda":
            return dist.batch_isend_irecv(ops)
        # NCCL's batched ops run on the calling thread's current device
        with torch.cuda.device(device):
            return dist.batch_isend_irecv(ops)

    def broadcast_(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank, in place."""
        if self.world > 1:
            dist.broadcast(x, src=0, group=self.world_group)
        return x

    def gather_dp_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every ``dp`` group's rows of ``x`` (dim 0), each from the
        group's first rank, side by side on every rank: the decode step's
        sampled rows into the whole batch. One world all-gather; with
        ``dp`` 1 it is rank 0's ``x`` (a broadcast), so every rank of a
        group holds one rank's values even where a tie could break
        differently."""
        if self.world == 1:
            return x
        if self.dp == 1:
            return self.broadcast_(x)
        parts = self.all_gather_world(x)
        return torch.cat(parts[::self.group_size])

    def all_gather_dp(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every ``dp`` peer's ``x`` (same shape), by ``dp`` index."""
        if self.dp == 1:
            return [x]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.dp)]
        dist.all_gather(parts, x, group=self.dp_group)
        return parts

    def broadcast_dp_(self, x: torch.Tensor, dp_src: int) -> torch.Tensor:
        """The ``x`` of the rank at ``dp_src`` along ``dp`` (this rank's
        other coordinates), in place on every rank of this rank's ``dp``
        group: a host-tier store's K/V rows, from the group whose slot
        holds them to the same heads of every other group."""
        if self.dp > 1:
            dist.broadcast(x, src=self.peer(AXIS_DP, dp_src),
                           group=self.dp_group)
        return x

    def send_to_leader_(self, x: torch.Tensor, dp_index: int) -> None:
        """Rank 0 receives ``x`` (in place) from ``dp`` group
        ``dp_index``'s first rank, which sends its own; every other rank
        and a group that holds rank 0 do nothing."""
        src = self.dp_leader(dp_index)
        if src == 0 or self.rank not in (0, src):
            return
        # NCCL's point-to-point ops run on the calling thread's device
        with (torch.cuda.device(x.device) if x.device.type == "cuda"
              else contextlib.nullcontext()):
            if self.rank == src:
                req = dist.isend(x, 0)
            else:
                req = dist.irecv(x, src)
        req.wait()

    def part_holders(self, kv_heads: int) -> List[int]:
        """One global rank for each distinct part of a host-tier block
        (:func:`kv_stripe` of the tokens, :func:`kv_head_range` of the KV
        heads) among the ranks at ``dp`` and ``ep`` index 0, stripe by
        stripe and in head order within one: the first of the ranks that
        share a head where ``tp`` is above ``kv_heads``."""
        parts = min(self.tp, kv_heads)
        return [rank_at(self.plan, sp=i, tp=t * (self.tp // parts))
                for i in range(self.sp) for t in range(parts)]

    def gather_parts(self, x: torch.Tensor, kv_heads: int,
                     sizes: List[int]) -> Optional[List[torch.Tensor]]:
        """Every distinct part of a block run (``x``, this rank's, a flat
        buffer; ``sizes[i]`` the elements of :meth:`part_holders`' ``i``-th
        rank's) on rank 0, in :meth:`part_holders`' order: one message
        from each holder, so each part moves once; any other rank sends
        nothing. None off rank 0."""
        holders = self.part_holders(kv_heads)
        if self.rank == 0:
            parts = [x] + [torch.empty(n, dtype=x.dtype, device=x.device)
                           for n in sizes[1:]]
            self._p2p([], list(zip(parts[1:], holders[1:])))
            return parts
        if self.rank in holders:
            self._p2p([(x, 0)], [])
        return None

    def scatter_from_leader_(self, x: Optional[torch.Tensor],
                             parts=None) -> Optional[torch.Tensor]:
        """Rank 0 sends ``parts[r]`` to every other rank ``r`` (one
        message each); every other rank receives into ``x`` in place."""
        if self.world == 1:
            return x
        if self.rank == 0:
            self._p2p([(parts[r], r) for r in range(1, self.world)], [])
        else:
            self._p2p([], [(x, 0)])
        return x

    @staticmethod
    def _p2p(sends, recvs) -> None:
        """Post ``sends`` and ``recvs`` ``[(tensor, global rank)]`` and
        wait for them (NCCL: a communicator per pair of ranks, as
        :meth:`send_to_leader_`; its point-to-point ops run on the calling
        thread's current device)."""
        pairs = sends + recvs
        if not pairs:
            return
        device = pairs[0][0].device
        with (torch.cuda.device(device) if device.type == "cuda"
              else contextlib.nullcontext()):
            reqs = [dist.isend(t, r) for t, r in sends]
            reqs += [dist.irecv(t, r) for t, r in recvs]
        for req in reqs:
            req.wait()

    def all_gather_world(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (same shape), in rank order."""
        if self.world == 1:
            return [x]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x, group=self.world_group)
        return parts


def init_mesh(
    plan: MeshPlan, rank: int, coordinator: str, device: torch.device,
    timeout_s: float = 600.0,
) -> Mesh:
    """Join the replica's process group (``coordinator`` ``host:port`` is
    rank 0's rendezvous) and build this rank's :class:`Mesh`: NCCL when
    ``device`` is a CUDA device, gloo when it is the CPU. There is no
    switch between them: a CUDA device without NCCL fails here."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if plan.chips > 1:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}",
            world_size=plan.chips, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
    return Mesh(plan, rank)


def close_mesh(mesh: Optional[Mesh]) -> None:
    """Leave the process group (a no-op for a single rank)."""
    if mesh is not None and mesh.world > 1 and dist.is_initialized():
        dist.destroy_process_group()

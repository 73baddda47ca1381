"""Mesh-sharded placement scoring: gangs x nodes over `torch.distributed`.

The counterpart of grove_tpu/parallel/sharded.py. PyTorch's idiom is one
process per device, so the mesh is a `DeviceMesh` over the ranks of the
process group, with dims ("gangs", "nodes"):

  - each rank keeps only its contiguous node block of the resident free
    state and of the one-hot membership matrix, and computes the partial
    domain aggregates over its own nodes: `m_l^T free_l` [D, R] and the
    per-signature fit counts `node_fits_l m_l` [U, D];
  - the partials are summed over the "nodes" dim in one fixed rank order
    that every rank shares (gathered, then added rank 0 first), so every
    rank holds the same bits of `dom_free` even on non-dyadic capacity
    (an all_reduce's order of addition depends on its algorithm);
  - each rank computes the value rows of its gang block with the value
    kernel (csrc/value_kernel.cu), the rows are gathered over the "gangs"
    dim in rank order, and the commit top-k kernel (csrc/commit_topk.cu)
    runs on the global [G, D] value on every rank: identical results
    everywhere, no divergence.

`sharded_score` is that program (K8, the reference's `sharded_score_fn`,
which builds a jitted function; here it is the eager function itself,
with its two collectives). `ShardedPlacementEngine` runs it as its device
phase; host encode and exact repair are the flat engine's, so placements
are bit-equal to the single-device engine's wherever the partial sums are
exact (integer and dyadic capacity, and always at one nodes rank).

The mesh program runs eagerly; it is not captured as a CUDA graph (gloo
collectives cannot be captured). A cancelled dispatch needs no
collective: every collective runs in the dispatch's begin half, which
every rank issues in the same order.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..solver import kernel_core as kc
from ..solver import programs
from ..solver.engine import (
    EncodedBacklog,
    PlacementEngine,
    Statics,
    membership_matrix,
    resolve_device,
)
from ..topology.encoding import TopologySnapshot

MESH_DIMS = ("gangs", "nodes")

#: the value kernel's operands (programs.value_operands' order) that are
#: per gang, and so cut to the rank's gang block
_GANG_OPERANDS = (2, 5, 6, 7, 8, 10)

def mesh_shape(n: int, gang_axis: int | None = None) -> tuple[int, int]:
    """(gangs, nodes) for `n` ranks: by default as even as possible with
    gangs >= nodes (8 -> 4 x 2, 4 -> 2 x 2, 2 -> 2 x 1, 1 -> 1 x 1);
    an explicit `gang_axis` must divide `n`."""
    if gang_axis is None:
        gang_axis = 1
        for f in range(math.isqrt(n), 0, -1):
            if n % f == 0:
                gang_axis = n // f
                break
    if n % gang_axis:
        raise ValueError(f"gang_axis {gang_axis} does not divide {n} ranks")
    return gang_axis, n // gang_axis


def make_solver_mesh(gang_axis: int | None = None, device=None) -> DeviceMesh:
    """A ("gangs", "nodes") DeviceMesh over the ranks of the initialised
    process group (`initialize_multihost`), on `device` (None = the card:
    this process's current CUDA device). `mesh.local_devices` is
    [this rank's device]. Never forms a group itself."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_solver_mesh needs a process group: call "
            "initialize_multihost() first"
        )
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    n = dist.get_world_size()
    gangs, nodes = mesh_shape(n, gang_axis)
    mesh = DeviceMesh(dev.type, torch.arange(n).reshape(gangs, nodes),
                      mesh_dim_names=MESH_DIMS)
    mesh.local_devices = [dev]
    return mesh


def _gather(mesh: DeviceMesh, dim: str, t: torch.Tensor) -> list:
    """`t` from every rank of the mesh dim `dim`, in that dim's rank
    order (one all_gather)."""
    parts = [torch.empty_like(t) for _ in range(mesh.size(MESH_DIMS.index(dim)))]
    dist.all_gather(parts, t, group=mesh.get_group(dim))
    return parts


def _sum_over_nodes(mesh: DeviceMesh, dom_free: torch.Tensor,
                    sig_cnt: torch.Tensor):
    """The partial aggregates summed over the "nodes" dim, added in rank
    order (rank 0 first) from one gather of both: the same bits on every
    rank."""
    flat = torch.cat([dom_free.reshape(-1), sig_cnt.reshape(-1)])
    parts = _gather(mesh, "nodes", flat)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    k = dom_free.numel()
    return total[:k].view(dom_free.shape), total[k:].view(sig_cnt.shape)


def mesh_operands(mesh: DeviceMesh, free: torch.Tensor, statics: Statics,
                  masks: torch.Tensor, io: torch.Tensor,
                  lay: programs.IoLayout):
    """K8's first half on this rank's node block: the io buffer's delta
    block (already routed to this rank's local rows, the rest to the
    absorbing row) applied in place to `free` [N_l + 1, R] (idempotent:
    rows are set, not added); the partial aggregates over the block's
    nodes (`statics` and `masks` are the block's), summed over "nodes".
    Returns the value kernel's operands for every gang
    (`programs.value_operands`' order, dom_free and sig_cnt the global
    sums, the same bits on every rank) and the gangs' demand [G, R]."""
    if lay.offsets["upd"][1]:
        programs.scatter_rows(free, lay.view(io, "upd"))
    p = programs.unpack_gangs(lay, io)
    ops = list(programs.value_operands(free[:-1], statics, masks, p))
    ops[0], ops[1] = _sum_over_nodes(mesh, ops[0], ops[1])
    return ops, p["td"]


def sharded_score(mesh: DeviceMesh, free: torch.Tensor, statics: Statics,
                  masks: torch.Tensor, io: torch.Tensor,
                  lay: programs.IoLayout, *, top_k: int,
                  chunk: int) -> torch.Tensor:
    """K8, the mesh program, on this rank's shards: `mesh_operands`, then
    the value rows of this rank's gang block (the value kernel, fp32),
    the rows gathered over "gangs", and the commit top-k on the global
    value. Returns the packed [G, 2K] result, the same on every rank."""
    ops, td = mesh_operands(mesh, free, statics, masks, io, lay)
    gl = td.shape[0] // mesh.size(0)
    lo = mesh.get_local_rank("gangs") * gl
    block = [o[lo: lo + gl] if i in _GANG_OPERANDS else o
             for i, o in enumerate(ops)]
    value_l = kc.kernel_value_sig(*block, precision="fp32")
    value = torch.cat(_gather(mesh, "gangs", value_l))
    packed = programs.commit(value, ops[0], statics.anc_ids, td,
                             top_k=top_k, chunk=chunk, device_commit=False)
    if packed.device.type == "cuda":
        programs.count_eager("K8")
    return packed


class ShardedPlacementEngine(PlacementEngine):
    """PlacementEngine whose flat device phase runs the mesh program.

    Host encode and exact repair are the flat engine's. `device` defaults
    to the mesh's local device and must be of its type."""

    def __init__(self, snapshot: TopologySnapshot, mesh: DeviceMesh,
                 top_k: int = 8, device=None, **kwargs):
        local = mesh.local_devices[0]
        dev = local if device is None else resolve_device(device)
        if dev.type != local.type:
            raise ValueError(
                f"device {dev} is not the mesh's device type {local.type}")
        super().__init__(snapshot, device=local, top_k=top_k, **kwargs)
        #: the incremental re-solve is single-device only on the FLAT
        #: path (its value-cache permutation is a gather across the gangs
        #: dim); the hierarchy keeps it in its sub-engines, which the
        #: base __init__ captured in _hier_incremental before this line
        self.incremental = False
        #: the kernel-tier and device-commit knobs likewise: the flat mesh
        #: program is its own pipeline (the value kernel in fp32, then the
        #: commit top-k; no device commit), and sub-engines keep the knobs
        #: asked for (_hier_pallas_core / _hier_device_commit)
        self.pallas_core = False
        self.device_commit = False
        self.mesh = mesh
        gangs, nodes = mesh.size(0), mesh.size(1)
        self._gangs_axis = gangs
        n = snapshot.num_nodes
        #: this rank's node block [lo, lo + n_l) of the padded node range:
        #: N padded to the nodes dim with dummy nodes of zero free
        #: capacity, no membership and mask 0
        self._n_l = -(-n // nodes)
        self._lo = mesh.get_local_rank("nodes") * self._n_l

    # -- what the mesh engine does not serve ---------------------------------
    def whatif_scores(self, gangs, free=None, free_rows=None):
        """The what-if reads the resident state whole; on a mesh the
        defragmenter takes its exact host path instead."""
        return None

    # -- the domain-sharded hierarchy ----------------------------------------
    def _sub_device(self, dom: int) -> torch.device:
        """Coarse domain `dom`'s sub-engine runs on one of this rank's
        devices, round-robin (one a rank: every sub-engine on it). No
        fine solve crosses ranks: every rank runs the identical coarse
        pass and fine solves, so the results stay replicated."""
        local = self.mesh.local_devices
        return local[dom % len(local)]

    def _auto_hier_workers(self) -> int:
        """At least as wide as the local device fan-out (bounded)."""
        return max(super()._auto_hier_workers(),
                   min(16, len(self.mesh.local_devices)))

    # -- the node block -------------------------------------------------------
    def _state_rows(self) -> tuple[int, int]:
        n = self.snapshot.num_nodes
        return min(self._lo, n), min(self._lo + self._n_l, n)

    def _state_put(self, masked: np.ndarray) -> torch.Tensor:
        """The rank's node block of the masked free matrix into its
        resident [N_l + 1, R] tensor (dummy rows zero, the absorbing row
        last)."""
        lo, hi = self._state_rows()
        r = masked.shape[1]
        if self._free_buf is None:
            self._free_buf = torch.zeros((self._n_l + 1, r),
                                         dtype=torch.float32,
                                         device=self.device)
        block = np.zeros((self._n_l, r), np.float32)
        block[: hi - lo] = masked[lo:hi]
        self._free_buf[: self._n_l].copy_(torch.from_numpy(block))
        return self._free_buf

    def _local_block(self, upd: np.ndarray) -> np.ndarray:
        """A delta block with its node rows made local to this rank's
        block: a row another rank owns, and every padding row, names the
        absorbing row N_l (JAX's mode="drop")."""
        lo, hi = self._state_rows()
        out = upd.copy()
        rows = upd[:, 0].astype(np.int64)
        own = (rows >= lo) & (rows < hi)
        out[:, 0] = np.where(own, rows - lo, self._n_l)
        return out

    def _state_delta(self, upd: np.ndarray) -> None:
        programs.scatter_rows(self._state.dev, self._h2d(self._local_block(upd)))

    def _ensure_statics(self) -> Statics:
        """The statics of this rank's node block: membership [N_l, D]
        (dummy nodes carry the absorbing domain id, so they are members of
        nothing) and `ones`, the default eligibility row, 1 on real nodes
        and 0 on dummies."""
        if self._statics is None:
            n = self.snapshot.num_nodes
            lo, n_l = self._lo, self._n_l
            d = self.space.num_domains
            gdom = np.full((self.space.gdom.shape[0], n_l), d, np.int32)
            real = max(0, min(n - lo, n_l))
            gdom[:, :real] = self.space.gdom[:, lo: lo + real]
            ones = np.zeros((1, n_l), np.float32)
            ones[:, :real] = 1.0
            self._statics = Statics(
                self._to_device(self.space.dom_level),
                self._to_device(self.space.anc_ids),
                self._to_device(self._cap_scale),
                membership_matrix(self._to_device(gdom), d),
                self._to_device(ones),
            )
        return self._statics

    def _block_masks(self, elig_masks: np.ndarray) -> torch.Tensor:
        """The eligibility table's columns of this rank's node block
        (dummy columns 0), on the device; the default table is the
        statics' `ones`."""
        if elig_masks.shape[0] == 1:
            return self._ensure_statics().ones
        lo, hi = self._state_rows()
        block = np.zeros((elig_masks.shape[0], self._n_l), np.float32)
        block[:, : hi - lo] = elig_masks[:, lo:hi]
        self._count_bytes("masks", block.nbytes)
        return self._h2d(block)

    def _pad_gangs(self, enc: EncodedBacklog) -> EncodedBacklog:
        """The gang arrays padded to a multiple of the gangs dim (zero
        rows, invalid); already so for a power-of-two dim."""
        pad = (-enc.g_pad) % self._gangs_axis
        if pad == 0:
            return enc

        def p(a):
            return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))

        u_sig_demand, u_sig_mask, elig_masks, sig_idx = enc.sig
        return dataclasses.replace(
            enc, total_demand=p(enc.total_demand),
            required_level=p(enc.required_level),
            preferred_level=p(enc.preferred_level), valid=p(enc.valid),
            fairness=p(enc.fairness),
            sig=(u_sig_demand, u_sig_mask, elig_masks, p(sig_idx)))

    # -- the device phase -----------------------------------------------------
    def mesh_inputs(self, enc: EncodedBacklog) -> tuple[tuple, dict]:
        """The arguments of `sharded_score` for an encoded backlog on this
        rank's shards (the staged delta rows taken, routed to the node
        block, and shipped in the io buffer): what the device phase
        launches, and what a caller timing K8 alone launches again."""
        if self._state.dev is None:
            raise RuntimeError(
                "device free state not synced: _device_begin requires a "
                "_sync_free call first (solve/dispatch do this)"
            )
        upd = self._take_staged() if self.fused else None
        if upd is not None:
            upd = self._local_block(upd)
        io, lay = self._build_io(self._pad_gangs(enc), upd)
        self._count_bytes("inputs", io.nbytes)
        args = (self.mesh, self._state.dev, self._ensure_statics(),
                self._block_masks(enc.sig[2]), self._h2d(io), lay)
        return args, {"top_k": min(self.top_k, self.space.num_domains),
                      "chunk": self.commit_chunk}

    def _device_begin(self, enc: EncodedBacklog,
                      allow_incremental: bool = True):
        """The mesh program on this rank's shards, its result's copy to
        the host queued. Every collective runs here."""
        g = enc.g_pad
        args, kw = self.mesh_inputs(enc)
        packed = sharded_score(*args, **kw)
        kind = "fused" if self.fused else "split"
        self._count_dispatch_kind(kind)
        self._last_begin = {"path": kind, "rows": len(enc.keys)}
        return self._token(packed[:g])

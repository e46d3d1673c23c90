"""Process meshes, the placement policy and the port's collectives: the
port of `attention_tpu.parallel.mesh`.

JAX names the axes of a device mesh and lets ``shard_map`` cut arrays
over them; here a `Mesh` names the axes of a ``torch.distributed``
world, one process (rank) per shard, and gives each axis its size, this
rank's index and the process group of the ranks along it.  The
reference's owner partitioner (`attention-mpi.c:19-27`) is each rank
slicing its own block of rows; its Bcast-vs-Scatterv choice
(`attention-mpi.c:210-266`) is `choose_kv_placement`.

Every collective of the port is a method of `Mesh`: all_reduce (MAX and
SUM, the two-phase softmax merge), all_gather, all_to_all (Ulysses) and
`Mesh.ppermute` (the ring's neighbour exchange and the pipeline's open
chain, JAX's ``lax.ppermute``, partial permutations included).
Without an initialised process group a mesh has one rank and every
collective returns its input: the reference's ``mpirun -np 1``, with the
kernels still on the card.  `grid_mesh` lays a world out as an N-D grid
with a process group per axis (the training mesh's dp x sp x tp).

Training goes through these collectives under autograd, in two
conventions.  On local blocks (what JAX runs inside ``shard_map``, the
model's path): `all_to_all_diff` (backward: the inverse all_to_all) and
`ppermute_diff` (backward: the inverse permutation); the all-gather of
K/V and its backward (JAX's ``psum_scatter``: gloo has no
reduce_scatter, so an all_reduce and a slice) sit inside the flash
autograd function (`parallel.cp.cp_attention_local`), which keeps the
gradients float32 until the sum.  On whole tensors that every rank holds
alike (the public functions' convention): `shard_whole` takes this
rank's block and `gather_whole` gives every rank the whole, each the
other's adjoint: the backward of `gather_whole` takes this rank's block
of the whole gradient and that of `shard_whole` all-gathers the blocks,
with no sum, since every rank computes the same loss of the same whole
output.

Tensor parallelism (the trainer's Megatron split of the projections)
adds the pair `tp_copy` (identity forward, all-reduce backward: a
replicated tensor entering weights split over the axis) and `tp_reduce`
(all-reduce forward in float32, identity backward: partial products),
and `row_parallel_linear`, which carries each rank's float32
accumulator into the sum so that the result is rounded once, as one
device's product is.  FSDP adds `Mesh.reduce_scatter` (each rank's
block of the sum), which has one route on every backend and device: an
all_reduce of the whole and this rank's slice (gloo has no
reduce-scatter for CUDA tensors).

gloo runs a world of several ranks on one card (NCCL refuses two ranks
on one device).  It takes CUDA tensors for some collectives and not for
others; `GLOO_CUDA_ROUTES` fixes, per collective, whether the device
tensor goes to gloo or a host copy does.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
import torch.distributed as dist

# Fallback threshold for callers that cannot supply the query-side
# shape, set where the byte model below lands for square shapes (m == n,
# d = 128: about 2.7 MB of fp32 KV), not at the reference's measured
# 64 MB (`attention-mpi.c:213-215`, an MPI broadcast-tree fact).
KV_REPLICATE_THRESHOLD_BYTES = 4 * 2**20

# Allreduce-vs-broadcast byte ratio: sharding pays a two-phase merge
# (reduce-scatter + all-gather, about twice the bytes on the wire) every
# call, where replication pays a one-time (1 - 1/R) broadcast (the 2x
# the reference's Iallreduce pair pays over its Ibcast,
# `attention-mpi.c:342,354` against `:305`).
MERGE_ALPHA = 2.0

# Replicating KV on every device is bounded by its memory long before
# it fills: leave room for Q, outputs and buffers.
KV_REPLICATE_HBM_CAP_BYTES = 4 * 2**30

#: how gloo takes each collective's CUDA tensors: "cuda" hands it the
#: device tensor, "host" copies it to the host and back.  Measured on an
#: H100 with torch 2.11: gloo all_reduce, all_gather and all_to_all take
#: device tensors; its point-to-point send and recv read a device pointer
#: as host memory ("writev ... Bad address").  Other backends and CPU
#: tensors take every collective directly.
GLOO_CUDA_ROUTES = {"all_reduce": "cuda", "all_gather": "cuda",
                    "all_to_all": "cuda", "ppermute": "host"}

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Mesh:
    """Named axes over a ``torch.distributed`` world (or one rank).

    ``shape[axis]`` is the axis's size, `index` this rank's position
    along it, `group` the process group of the ranks that differ from
    this one only along it.  ``timings``, when set to a dict, collects
    the host seconds each collective takes (the card synchronised before
    and after it), by collective name."""

    def __init__(self, axis_names, sizes, coords, ranks, groups):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))
        self._coords = dict(zip(self.axis_names, coords))
        self._ranks = dict(zip(self.axis_names, ranks))
        self._groups = dict(zip(self.axis_names, groups))
        self.timings: dict | None = None

    def index(self, axis: str) -> int:
        return self._coords[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def route(self, name: str, device: torch.device) -> str:
        """How collective ``name`` moves tensors on ``device``: "cpu"
        for CPU tensors; for CUDA tensors "cuda" (the device tensor goes
        to the backend) or "host" (a host copy does, `GLOO_CUDA_ROUTES`)."""
        if device.type != "cuda":
            return "cpu"
        if dist.get_backend(self._groups[self.axis_names[0]]) != "gloo":
            return "cuda"
        return GLOO_CUDA_ROUTES[name]

    @contextlib.contextmanager
    def _timed(self, name: str, device: torch.device):
        if self.timings is None:
            yield
            return
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.timings[name] = (self.timings.get(name, 0.0)
                              + time.perf_counter() - t0)

    def _staged(self, name: str, x: torch.Tensor, *,
                copy: bool = False) -> torch.Tensor:
        """``x`` contiguous, and on the host where gloo cannot take it
        from the card; a copy where ``copy`` (the in-place reductions)."""
        if self.route(name, x.device) == "host":
            return x.to("cpu", memory_format=torch.contiguous_format)
        if copy:
            return torch.clone(x, memory_format=torch.contiguous_format)
        return x.contiguous()

    def all_reduce(self, x: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        """The ``op`` ("sum" or "max") of ``x`` over the ranks along
        ``axis``, on every one of them (``lax.psum`` / ``lax.pmax``)."""
        if self.shape[axis] == 1:
            return x
        with self._timed("all_reduce", x.device):
            y = self._staged("all_reduce", x, copy=True)
            dist.all_reduce(y, op=_REDUCE_OPS[op], group=self._groups[axis])
            return y.to(x.device)

    def reduce_scatter(self, x: torch.Tensor, axis: str,
                       dim: int) -> torch.Tensor:
        """This rank's block along ``dim`` (a multiple of the axis's size)
        of the sum of ``x`` over the ranks along ``axis``
        (``lax.psum_scatter(..., tiled=True)``), by one route on every
        backend and device: an all_reduce of the whole and this rank's
        slice, so that FSDP's gradient is the bits of the replicated
        one."""
        r = self.shape[axis]
        if r == 1:
            return x
        width = x.shape[dim] // r
        whole = self.all_reduce(x, axis, "sum")
        return whole.narrow(dim, self.index(axis) * width, width).contiguous()

    def all_gather(self, x: torch.Tensor, axis: str,
                   dim: int) -> torch.Tensor:
        """The ranks' ``x`` along ``axis`` concatenated on ``dim`` in
        their index order, on every one of them."""
        if self.shape[axis] == 1:
            return x
        with self._timed("all_gather", x.device):
            y = self._staged("all_gather", x)
            out = [torch.empty_like(y) for _ in range(self.shape[axis])]
            dist.all_gather(out, y, group=self._groups[axis])
            return torch.cat(out, dim=dim).to(x.device)

    def all_to_all(self, x: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """``lax.all_to_all(..., tiled=True)``: ``x`` cut into R chunks on
        ``split_dim``, chunk j sent to the rank of index j along
        ``axis``, the chunks received concatenated on ``concat_dim`` in
        the senders' index order."""
        r = self.shape[axis]
        if r == 1:
            return x
        with self._timed("all_to_all", x.device):
            y = self._staged("all_to_all", torch.stack(x.chunk(r, split_dim)))
            out = torch.empty_like(y)
            dist.all_to_all_single(out, y, group=self._groups[axis])
            return torch.cat(out.to(x.device).unbind(0), dim=concat_dim)

    def ppermute(self, xs, axis: str, perm) -> "Pending":
        """Start ``lax.ppermute`` of the tensors ``xs``: the rank of
        index ``src`` along ``axis`` sends them to the one of index
        ``dst``, for each ``(src, dst)`` of ``perm``, a permutation or,
        as ``lax.ppermute`` takes it, a partial one: a rank that is no
        ``src`` sends nothing, and one that is no ``dst`` receives zeros
        (of the shapes of its ``xs``).  Returns at once; `Pending.wait`
        gives the tensors received."""
        me = self._coords[axis]
        dst = dict(perm).get(me)
        src = {d: s for s, d in perm}.get(me)
        if dst == me:
            return Pending(list(xs), [], None, None)
        device = xs[0].device
        if dst is None and src is None:
            return Pending([torch.zeros_like(x) for x in xs], [], device,
                           self)
        with self._timed("ppermute", device):
            send = [self._staged("ppermute", x) for x in xs]
            group, peers = self._groups[axis], self._ranks[axis]
            # one tag per tensor: the sends to one peer match its
            # receives by tag, not by order
            ops = []
            if dst is not None:
                ops += [dist.P2POp(dist.isend, x, peers[dst], group, tag)
                        for tag, x in enumerate(send)]
            if src is None:
                recv = [torch.zeros_like(x) for x in xs]
            else:
                recv = [torch.empty_like(x) for x in send]
                ops += [dist.P2POp(dist.irecv, x, peers[src], group, tag)
                        for tag, x in enumerate(recv)]
            works = dist.batch_isend_irecv(ops)
        return Pending(recv, works, device, self)


class Pending:
    """The tensors of a started `Mesh.ppermute`; `wait` ends it."""

    def __init__(self, tensors, works, device, mesh):
        self._tensors, self._works = tensors, works
        self._device, self._mesh = device, mesh

    def wait(self) -> list[torch.Tensor]:
        if not self._works:
            return self._tensors
        with self._mesh._timed("ppermute", self._device):
            for work in self._works:
                work.wait()
            return [t.to(self._device) for t in self._tensors]


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return mesh.all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return (mesh.all_to_all(g.contiguous(), axis, concat_dim, split_dim),
                None, None, None, None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, perm, *xs):
        ctx.args = (mesh, axis, [(d, s) for s, d in perm])
        out = mesh.ppermute(xs, axis, perm).wait()
        return tuple(y.clone() if y is x else y for x, y in zip(xs, out))

    @staticmethod
    def backward(ctx, *gs):
        mesh, axis, inverse = ctx.args
        gs = [g.contiguous() for g in gs]
        return (None, None, None,
                *mesh.ppermute(gs, axis, inverse).wait())


class _ShardWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        width = x.shape[dim] // mesh.shape[axis]
        return x.narrow(dim, mesh.index(axis) * width, width).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return mesh.all_gather(g.contiguous(), axis, dim), None, None, None


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        width = g.shape[dim] // mesh.shape[axis]
        return (g.narrow(dim, mesh.index(axis) * width, width), None, None,
                None)


class _TPCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return _sum_float32(g, mesh, axis), None, None


class _TPReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _sum_float32(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _sum_float32(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` taken in float32 and rounded once to
    ``x``'s dtype: a bf16 sum over ranks would round at every add."""
    return mesh.all_reduce(x.float(), axis, "sum").to(x.dtype)


def tp_copy(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Megatron's ``f``: ``x`` as it is, whose gradient is summed over
    ``axis`` (in float32, rounded once).  A tensor that every rank along
    the axis holds alike goes through it before weights split over the
    axis (column-parallel), so that each rank's partial gradient of it
    adds up to the whole."""
    if mesh.shape[axis] == 1:
        return x
    return _TPCopy.apply(x, mesh, axis)


def tp_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Megatron's ``g``: the sum of the ranks' partial ``x`` over
    ``axis`` (in float32, rounded once to ``x``'s dtype), whose gradient
    passes to each rank as it is.  Row-parallel products end with it."""
    if mesh.shape[axis] == 1:
        return x
    return _TPReduce.apply(x, mesh, axis)


def _product_float32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (2-D) accumulated and returned in float32."""
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        return torch.mm(x, w, out_dtype=torch.float32)
    # the CPU's matmul has no float32 output for bf16 operands: the
    # operands widened exactly give the same products and sums
    return x.float() @ w.float()


class _Float32Product(torch.autograd.Function):
    """``x @ w.T`` of bf16 (or f16) operands, accumulated and returned in
    float32; the backward is a ``Linear``'s in the operands' dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _product_float32(x.reshape(-1, x.shape[-1]), w.T).view(
            *x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w, g.reshape(-1, g.shape[-1]).T @ x.reshape(
            -1, x.shape[-1])


def row_parallel_linear(x: torch.Tensor, weight: torch.Tensor, mesh: Mesh,
                        axis: str) -> torch.Tensor:
    """A row-parallel product: this rank's input block ``x`` (..., k / n)
    times its block of a weight split on its input dim (out, k / n),
    summed over ``axis``.  Each rank's partial stays float32 through the
    sum (`tp_reduce`) and the result is rounded once to ``x``'s dtype, as
    the single device's product rounds its float32 accumulator once."""
    if x.dtype == torch.float32:
        return tp_reduce(torch.nn.functional.linear(x, weight), mesh, axis)
    return tp_reduce(_Float32Product.apply(x, weight), mesh,
                     axis).to(x.dtype)


def all_to_all_diff(x: torch.Tensor, mesh: Mesh, axis: str, split_dim: int,
                    concat_dim: int) -> torch.Tensor:
    """`Mesh.all_to_all` under autograd; the backward is the inverse
    all_to_all (``split_dim`` and ``concat_dim`` swapped)."""
    if mesh.shape[axis] == 1:
        return x
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)


def ppermute_diff(xs, mesh: Mesh, axis: str, perm) -> list[torch.Tensor]:
    """`Mesh.ppermute` of the tensors ``xs``, waited for, under autograd;
    the backward sends the gradients along the inverse permutation."""
    return list(_PPermute.apply(mesh, axis, perm, *xs))


def shard_whole(x: torch.Tensor, mesh: Mesh, axis: str,
                dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` (a multiple of the axis's size) of
    a tensor that every rank holds whole; the backward all-gathers the
    ranks' gradient blocks into the whole gradient, with no sum."""
    if mesh.shape[axis] == 1:
        return x
    return _ShardWhole.apply(x, mesh, axis, dim)


def gather_whole(x: torch.Tensor, mesh: Mesh, axis: str,
                 dim: int) -> torch.Tensor:
    """The ranks' blocks along ``axis`` concatenated on ``dim``, on every
    rank; the backward takes this rank's block of the whole gradient,
    with no sum (every rank computes the same loss of the whole)."""
    if mesh.shape[axis] == 1:
        return x
    return _GatherWhole.apply(x, mesh, axis, dim)


def whole_layout(q, k, mesh: Mesh, axis_name: str, batch_axis, head_axis):
    """The (mesh axis, dim) pairs that cut a whole (b, h, s, d) or (h, s,
    d) tensor into this rank's block, in order: the sequence over
    ``axis_name``, the batch over ``batch_axis`` and the heads over
    ``head_axis`` where the mesh has them and they divide (the heads only
    where both q's and k's head counts divide), as JAX's ``in_specs``."""
    seq = q.dim() - 2
    layout = [(axis_name, seq)]
    if q.dim() == 4:
        b_axis = _maybe_axis(mesh, batch_axis, q.shape[0])
        if b_axis is not None:
            layout.append((b_axis, 0))
    h_axis = _maybe_axis(mesh, head_axis, q.shape[-3])
    if h_axis is not None and k.shape[-3] % mesh.shape[h_axis] == 0:
        layout.append((h_axis, q.dim() - 3))
    return layout


def shard_blocks(xs, mesh: Mesh, layout):
    """Each whole tensor of ``xs`` cut to this rank's block (`shard_whole`
    along each axis of ``layout``)."""
    out = []
    for x in xs:
        for axis, dim in layout:
            x = shard_whole(x, mesh, axis, dim)
        out.append(x)
    return out


def gather_blocks(x, mesh: Mesh, layout):
    """The whole tensor from every rank's block (`gather_whole` along the
    axes of ``layout`` in reverse)."""
    for axis, dim in reversed(layout):
        x = gather_whole(x, mesh, axis, dim)
    return x


def _world() -> tuple[int, int]:
    """(size, rank) of the default process group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def default_mesh(axis_name: str = "kv") -> Mesh:
    """A 1-D mesh over every rank of the default process group (the
    ``MPI_COMM_WORLD`` analog); one rank when none is initialised."""
    size, rank = _world()
    return Mesh((axis_name,), (size,), (rank,), (list(range(size)),),
                (None,))


def grid_mesh(axis_names, sizes) -> Mesh:
    """The world laid out as a grid of ``sizes`` (row-major: the last
    axis varies fastest between consecutive ranks), one process group
    per line of ranks along each axis.  Every rank must call it, in the
    same order (process groups are created collectively)."""
    size, rank = _world()
    total = 1
    for s in sizes:
        total *= s
    if total != size:
        raise ValueError(f"mesh {tuple(sizes)} needs {total} ranks; the "
                         f"world has {size}")
    strides = [1] * len(sizes)
    for a in range(len(sizes) - 2, -1, -1):
        strides[a] = strides[a + 1] * sizes[a + 1]
    coords = [rank // st % s for st, s in zip(strides, sizes)]
    ranks, groups = [], []
    for a, (st, s) in enumerate(zip(strides, sizes)):
        ranks.append([rank + (j - coords[a]) * st for j in range(s)])
        mine = None
        if size > 1 and s > 1:
            for base in range(size):
                if base // st % s:
                    continue
                line = [base + j * st for j in range(s)]
                group = dist.new_group(line)
                if rank in line:
                    mine = group
        groups.append(mine)
    return Mesh(axis_names, sizes, coords, ranks, groups)


def hybrid_mesh(inner_axis: str = "kv", outer_axis: str = "dp", *,
                outer: int | None = None) -> Mesh:
    """A 2-D (outer, inner) mesh: rank r sits at (r // inner, r % inner),
    one process group per row and per column.  The inner axis groups the
    ranks of one host (their collectives, the two-phase merge and the
    ring, stay on the host's links); the outer axis crosses hosts and
    carries low-frequency traffic.  ``outer`` defaults to the number of
    hosts, the world size over ``LOCAL_WORLD_SIZE`` (which
    ``torch.distributed.run`` sets; 1 without it, the single-host
    (1, world) mesh of the JAX package).  Every rank must call it."""
    size, _ = _world()
    if outer is None:
        outer = size // int(os.environ.get("LOCAL_WORLD_SIZE", size))
    if outer < 1 or size % outer:
        raise ValueError(f"outer axis {outer} does not divide {size} ranks")
    return grid_mesh((outer_axis, inner_axis), (outer, size // outer))


def _maybe_axis(mesh: Mesh, axis: str | None, dim: int) -> str | None:
    """Use ``axis`` for a dim only if the mesh has it and it divides."""
    if axis is None or axis not in mesh.axis_names:
        return None
    if dim % mesh.shape[axis] != 0:
        return None
    return axis


def choose_kv_placement(
    n: int,
    dk: int,
    dv: int,
    *,
    itemsize: int = 4,
    threshold_bytes: int = KV_REPLICATE_THRESHOLD_BYTES,
    kv_heads: int = 1,
    m: int | None = None,
    q_heads: int | None = None,
    n_devices: int | None = None,
) -> str:
    """'replicate' or 'shard': the adaptive distribution policy.

    Both placements do the same operations; they differ in bytes moved.
    Replicating KV (Q sharded) pays a one-time (1 - 1/R) broadcast of
    the KV and no per-call collective; sharding KV rows moves 1/R of it
    but pays the two-phase merge every call (the (h, m) stats and the
    (h, m, dv) fp32 contributions, about twice those bytes on the wire).
    With the query side known, replicate iff ``(1 - 1/R) * kv_bytes <
    MERGE_ALPHA * merge_bytes``, capped by device memory; without ``m``,
    compare the KV bytes with ``threshold_bytes``.  ``n_devices`` (R)
    defaults to the size of the default process group."""
    total_kv = kv_heads * n * (dk + dv) * itemsize
    if total_kv > KV_REPLICATE_HBM_CAP_BYTES:
        return "shard"  # capacity-forced regardless of comm optimum
    if m is None:
        return "replicate" if total_kv < threshold_bytes else "shard"
    if n_devices is None:
        n_devices = _world()[0]
    bcast_bytes = (1.0 - 1.0 / n_devices) * total_kv
    # stats ride as fp32 (2 vectors) beside the fp32 contributions
    merge_bytes = (q_heads or kv_heads) * m * (dv + 2) * 4
    return ("replicate"
            if bcast_bytes < MERGE_ALPHA * merge_bytes else "shard")

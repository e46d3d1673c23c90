"""Token-choice top-k mixture-of-experts MLP: the port of
`attention_tpu.models.moe.MoEMLP`.

The semantics are the JAX module's, line for line:

    router probs (T, E) in float32 -> top-k experts per token (ties to
    the lower index), their weights renormalised to sum to 1
    capacity C = max(ceil(k * T * capacity_factor / E), 1), T = every
    token of the call
    slots: choice-major (all first choices before any second), a
    (token, choice) pair past its expert's C slots dropped (zero weight:
    the block's residual carries the token)
    experts: (E, C, d) @ (E, d, h), tanh GELU, @ (E, h, d), in the model
    dtype, h = 4 d
    aux loss: aux_weight * E * sum_e(f_e * p_e) over first choices

The JAX module moves tokens in and out of the experts' buffers with
one-hot ``einsum``s, the TPU's static-shape device.  Here a gather puts
each kept pair's row in its slot (an exact copy, as the one-hot product
is) and a gather of each pair's expert output, weighted and summed over
the k choices in float32, brings it back (one rounding to the model
dtype, as the one-hot product's float32 accumulation does).  Neither
reads a length back to the host: a dropped pair points at a zero row.

On a mesh the layer keeps JAX's global semantics, where the layer sees
every token of the global batch.  Tokens split over the trainer's data
and sequence axes (`TokenShards`, set by `models.train.value_and_grad`):
every rank all-gathers the top-k ids of the others (a few ints a token),
so that T, the capacity and each pair's slot are the global ones (the
choice-major cumsum over the global token order, a padded position
taking no slot), and its aux loss is its share, ``aux_weight * E *
sum_e(f_e * p_e_local)`` with the global first-choice fractions f_e and
its own tokens' probabilities over the global T: the shares of the ranks
sum to JAX's loss and each rank's gradient through its probabilities is
JAX's.  Experts split over an axis whose ranks hold the same tokens
(``ep_axis``, or "tp" where `models.train.shard_params` split them):
each rank runs its E / n experts on the slots its tokens own (the
others' slots stay zero rows) and the outputs are summed over the axis
in float32 (`parallel.mesh.tp_reduce`); the expert inputs and the
combine weights enter through `parallel.mesh.tp_copy`, which sums their
gradients over the axis.  Experts split over an axis whose ranks hold
other tokens (an ``ep_axis`` of "dp" or the cp axis, where JAX's XLA
moves the tokens with all-to-alls): each rank fills its own tokens'
slots of the whole (E, C, d) buffer, an all-to-all
(`parallel.mesh.all_to_all_diff`, whose backward is the inverse one)
sends each expert's block to the rank that holds the expert, which sums
the senders' blocks (their slots are disjoint: each row exactly), runs
its experts, and a second all-to-all brings every expert's outputs back
to every rank, which takes its own tokens' rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from attention_tpu_torch.parallel.mesh import (
    all_to_all_diff,
    tp_copy,
    tp_reduce,
)


def capacity(tokens: int, num_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots per expert, as the JAX module computes them (a float
    ceiling by negated floor division, at least 1)."""
    return max(int(-(-top_k * tokens * capacity_factor // num_experts)), 1)


def route(probs: torch.Tensor, top_k: int) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """``lax.top_k`` of (T, E) router probabilities: the k largest,
    descending, ties broken toward the lower expert index (a stable
    sort), and their expert ids, each (T, k)."""
    values, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[:, :top_k], ids[:, :top_k]


class TokenShards(NamedTuple):
    """How a trainer's mesh splits the tokens an MoE layer sees: rows
    over ``batch_axis``, positions over ``seq_axis`` (None: not split
    over it), the global batch's ``seq_len`` positions padded to a
    multiple of the sequence axis (a position at or past ``seq_len`` is
    padding, which takes no slot and no share of the aux loss)."""

    mesh: object
    batch_axis: str | None
    seq_axis: str | None
    seq_len: int


#: the experts' hidden width over the model's, and the aux loss's weight
#: (the JAX module's defaults, which every caller keeps)
HIDDEN_MULT = 4
AUX_LOSS_WEIGHT = 0.01


class MoEMLP(nn.Module):
    """(B, S, d) -> ((B, S, d), aux loss): ``num_experts`` GELU MLPs of
    width `HIDDEN_MULT`·d, each token sent to its ``top_k`` experts.
    The router is a float32 ``Linear`` (d -> E; float64 in a float64
    model, the witness of the card's checks), JAX's (d, E) kernel
    transposed as every ``Dense`` kernel is in the port; the experts are
    (E, d, h) and (E, h, d) in ``dtype``, JAX's layout.  ``forward``
    returns the aux loss beside the output, so that a caller that
    recomputes the layer (remat) or splits the batch counts it once.
    ``ep_axis`` (an axis of ``mesh``; JAX's `ValueError` when the mesh
    lacks it, no effect without a mesh) splits the experts over that
    axis: each rank holds the whole experts, or its block of them once
    `models.train.shard_params` cut them, and runs only its block, on
    the tokens of every rank of the axis where a trainer's
    `TokenShards` split the tokens over it (see the module
    docstring)."""

    def __init__(self, dim: int, num_experts: int, *, top_k: int = 2,
                 capacity_factor: float = 1.25, ep_axis: str | None = None,
                 mesh=None, dtype: torch.dtype, device):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k {top_k} must be in [1, "
                             f"num_experts={num_experts}]")
        if mesh is not None and ep_axis is not None \
                and ep_axis not in mesh.axis_names:
            # JAX's refusal: never a fall-through to replicated experts
            raise ValueError(
                f"ep_axis {[ep_axis]} not in the current mesh (axes "
                f"{tuple(mesh.axis_names)}); pass the mesh that has it or "
                "fix the axis name")
        self.ep_axis, self.mesh = ep_axis, mesh
        #: set by `models.train.shard_params`: the mesh whose "tp" axis
        #: splits this layer's weights and the names of those it splits;
        #: set by `models.train.value_and_grad` for a step: `TokenShards`
        self.tp_mesh, self.tp_split = None, frozenset()
        self.token_shards: TokenShards | None = None
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        h = dim * HIDDEN_MULT
        self.router = nn.Linear(
            dim, num_experts, bias=False, device=device,
            dtype=torch.promote_types(torch.float32, dtype))
        self.experts_up = nn.Parameter(torch.empty(
            num_experts, dim, h, dtype=dtype, device=device))
        self.experts_down = nn.Parameter(torch.empty(
            num_experts, h, dim, dtype=dtype, device=device))

    def _split(self):
        """(mesh, axis) the experts are split over, or None: ``ep_axis``
        on the layer's mesh, else "tp" where `shard_params` cut them;
        None where the axis does not divide E (replicated experts, as
        JAX's ``_legal_spec`` leaves them)."""
        if self.ep_axis is not None and self.mesh is not None:
            mesh, axis = self.mesh, self.ep_axis
        elif "experts_up" in self.tp_split:
            mesh, axis = self.tp_mesh, "tp"
        else:
            return None
        n = mesh.shape[axis]
        if n == 1 or self.num_experts % n:
            return None
        return mesh, axis

    def _experts(self, split):
        """This rank's (lo, up, down): its first expert and its block of
        the expert weights (a slice of whole weights enters through
        `tp_copy`, so that its gradient is whole on every rank)."""
        up, down = self.experts_up, self.experts_down
        if split is None:
            return 0, up, down
        mesh, axis = split
        local = self.num_experts // mesh.shape[axis]
        lo = mesh.index(axis) * local
        if up.shape[0] == local:
            return lo, up, down
        return lo, *(tp_copy(w, mesh, axis).narrow(0, lo, local)
                     for w in (up, down))

    def _global_pairs(self, tope: torch.Tensor, b: int, s: int):
        """(global top-k ids (Tg, k) in the global token order with
        ``num_experts`` at padded positions, the global index of each of
        this rank's tokens (T,), the global count of real tokens, this
        rank's real-token mask (T,) or None)."""
        e, shards = self.num_experts, self.token_shards
        if shards is None:
            return tope, None, b * s, None
        mesh, dev = shards.mesh, tope.device
        sp_i = mesh.index(shards.seq_axis) if shards.seq_axis else 0
        pos = sp_i * s + torch.arange(s, device=dev)
        valid = (pos < shards.seq_len).expand(b, s).reshape(-1)
        ids = torch.where(valid[:, None], tope, e).to(torch.int32)
        ids = ids.view(b, s, -1)
        if shards.seq_axis is not None:
            ids = mesh.all_gather(ids, shards.seq_axis, dim=1)
        if shards.batch_axis is not None:
            ids = mesh.all_gather(ids, shards.batch_axis, dim=0)
        rows, cols = ids.shape[:2]
        dp_i = mesh.index(shards.batch_axis) if shards.batch_axis else 0
        row = dp_i * b + torch.arange(b, device=dev)
        gidx = (row[:, None] * cols + pos[None, :]).reshape(-1)
        total = rows * shards.seq_len
        return ids.reshape(rows * cols, -1).long(), gidx, total, valid

    def forward(self, x: torch.Tensor):
        b, s, d = x.shape
        e, k = self.num_experts, self.top_k
        t = b * s
        xt = x.reshape(t, d)
        # the router in float32 (or a wider model dtype): expert choice
        # is precision-sensitive
        probs = torch.softmax(self.router(xt.to(self.router.weight.dtype)),
                              dim=-1)
        topv, tope = route(probs, k)
        topv = topv / topv.sum(-1, keepdim=True)
        ids_all, gidx, total, valid = self._global_pairs(tope, b, s)
        cap = capacity(total, e, k, self.capacity_factor)

        # each (choice, token) pair's slot in its expert's buffer: how
        # many earlier pairs chose the same expert, first choices first,
        # over the global tokens (a padded position's id e takes none)
        onehot = F.one_hot(ids_all.T.reshape(-1), e + 1)[:, :e]
        slot = ((onehot.cumsum(0) - 1) * onehot).sum(-1)
        if gidx is not None:
            slot = slot.view(k, -1)[:, gidx].reshape(-1)
        ids = tope.T.reshape(-1)
        keep = slot < cap
        if valid is not None:
            keep = keep & valid.repeat(k)
        split = self._split()
        lo, w_up, w_down = self._experts(split)
        local = w_up.shape[0]
        # experts over an axis whose ranks hold other tokens: this rank's
        # tokens fill their slots of the whole (E, C, d) buffer, each
        # expert's block goes to the rank that holds the expert and its
        # outputs come back (all-to-alls); else this rank's tokens fill
        # the slots of its own experts and the outputs are summed
        shards = self.token_shards
        a2a = split is not None and shards is not None \
            and split[1] in (shards.batch_axis, shards.seq_axis)
        first, count = (0, e) if a2a else (lo, local)
        weights, xe = topv, xt
        if split is not None and not a2a:
            weights, xe = (tp_copy(z, *split) for z in (topv, xt))
        weight = weights.T.reshape(-1) * keep
        # each pair's row in the flattened (count*C,) buffer; pairs
        # dropped or on another rank's experts point past it, at a zero
        # row
        mine = keep & (ids >= first) & (ids < first + count)
        dest = torch.where(mine, (ids - first) * cap + slot, count * cap)
        owner = torch.full((count * cap + 1,), t, dtype=torch.long,
                           device=x.device)
        owner.scatter_(0, dest, torch.arange(t, device=x.device).repeat(k))
        rows = torch.cat([xe.to(self.dtype),
                          xe.new_zeros(1, d, dtype=self.dtype)])
        xin = rows[owner[:-1]].view(count, cap, d)
        if a2a:
            # the senders' rows of one expert lie in disjoint slots, so
            # their sum is each row exactly
            n = e // local
            xin = all_to_all_diff(xin, *split, 0, 0).view(
                n, local, cap, d).sum(0)
        hmid = F.gelu(torch.bmm(xin, w_up), approximate="tanh")
        xout = torch.bmm(hmid, w_down).to(x.dtype)
        if a2a:
            xout = all_to_all_diff(xout.repeat(n, 1, 1), *split, 0, 0)
        out = torch.cat([xout.reshape(count * cap, d), xout.new_zeros(1, d)])
        y = (weight.to(x.dtype).float()[:, None] * out[dest].float()) \
            .view(k, t, d).sum(0)
        if split is not None and not a2a:
            y = tp_reduce(y, *split)

        # switch aux loss over first choices
        if self.token_shards is None:
            f_e = F.one_hot(tope[:, 0], e).to(probs.dtype).mean(0)
            p_e = probs.mean(0)
        else:
            # the global first-choice fractions, and this rank's share of
            # the mean probabilities
            f_e = onehot[:ids_all.shape[0]].sum(0).to(probs.dtype) / total
            p_e = (probs * valid[:, None]).sum(0) / total
        aux = AUX_LOSS_WEIGHT * e * (f_e * p_e).sum()
        return y.reshape(b, s, d).to(x.dtype), aux

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
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


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
    recomputes the layer (remat) or splits the batch counts it once."""

    def __init__(self, dim: int, num_experts: int, *, top_k: int = 2,
                 capacity_factor: float = 1.25, ep_axis: str | None = None,
                 dtype: torch.dtype, device):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k {top_k} must be in [1, "
                             f"num_experts={num_experts}]")
        if ep_axis is not None:
            raise NotImplementedError(
                "ep_axis: expert parallelism over a model mesh is not "
                "ported; the port runs every expert on one device")
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

    def forward(self, x: torch.Tensor):
        b, s, d = x.shape
        e, k = self.num_experts, self.top_k
        t = b * s
        cap = capacity(t, e, k, self.capacity_factor)
        xt = x.reshape(t, d)
        # the router in float32 (or a wider model dtype): expert choice
        # is precision-sensitive
        probs = torch.softmax(self.router(xt.to(self.router.weight.dtype)),
                              dim=-1)
        topv, tope = route(probs, k)
        topv = topv / topv.sum(-1, keepdim=True)

        # each (choice, token) pair's slot in its expert's buffer: how
        # many earlier pairs chose the same expert, first choices first
        ids = tope.T.reshape(-1)
        onehot = F.one_hot(ids, e)
        slot = ((onehot.cumsum(0) - 1) * onehot).sum(-1)
        keep = slot < cap
        weight = topv.T.reshape(-1) * keep
        # each pair's row in the flattened (E*C,) buffer; dropped pairs
        # point past it, at a zero row
        dest = torch.where(keep, ids * cap + slot, e * cap)
        owner = torch.full((e * cap + 1,), t, dtype=torch.long,
                           device=x.device)
        owner.scatter_(0, dest, torch.arange(t, device=x.device).repeat(k))
        rows = torch.cat([xt.to(self.dtype),
                          xt.new_zeros(1, d, dtype=self.dtype)])
        xin = rows[owner[:-1]].view(e, cap, d)
        hmid = F.gelu(torch.bmm(xin, self.experts_up), approximate="tanh")
        xout = torch.bmm(hmid, self.experts_down).to(x.dtype)
        out = torch.cat([xout.reshape(e * cap, d), xout.new_zeros(1, d)])
        y = (weight.to(x.dtype).float()[:, None] * out[dest].float()) \
            .view(k, t, d).sum(0)

        # switch aux loss over first choices
        f_e = F.one_hot(tope[:, 0], e).to(probs.dtype).mean(0)
        p_e = probs.mean(0)
        aux = AUX_LOSS_WEIGHT * e * (f_e * p_e).sum()
        return y.reshape(b, s, d).to(x.dtype), aux

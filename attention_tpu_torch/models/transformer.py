"""Transformer block and tiny decoder LM: the port of
`attention_tpu.models.transformer`.

Pre-norm decoder blocks (RMSNorm -> GQA attention -> residual, RMSNorm
-> GELU MLP, or a mixture of experts, -> residual), then a final RMSNorm
and a float32 logits head, with the JAX modules' dtype rules: the blocks
compute in the model dtype, the norms, the MoE router and the head in
float32.  Weights come from `init_params` (seeded, on the model's
device) or from the JAX package's flax params through
`models.convert.params_from_jax`.

Under the trainer's tensor-parallel layout (`models.train.shard_params`
on a mesh with a "tp" axis) each rank holds its block of the weights and
the uncached forward runs Megatron's split: the MLP column-parallel up
and row-parallel down, the embedding vocab-parallel (a masked lookup of
this rank's rows, summed over tp), the attention on this rank's heads
(`attention_layer`), the MoE experts on their block (`moe`); `features`
stops before the float32 head, whose vocab-parallel cross entropy the
trainer takes without building whole logits, and ``forward`` gathers
the head's vocab blocks into whole logits.
"""

from __future__ import annotations

import inspect

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from attention_tpu_torch.device import resolve_device
from attention_tpu_torch.models.attention_layer import (
    GQASelfAttention,
    KVCache,
    RollingKVCache,
    check_impl,
)
from attention_tpu_torch.models.moe import MoEMLP
from attention_tpu_torch.parallel.mesh import (
    gather_whole,
    row_parallel_linear,
    tp_copy,
    tp_reduce,
)

RMS_EPS = 1e-6  # flax.linen.RMSNorm's default epsilon


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + RMS_EPS)
        return (y * self.scale).to(self.dtype)


class MLP(nn.Module):
    def __init__(self, dim: int, hidden_mult: int = 4, *,
                 dtype: torch.dtype, device):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        self.up = nn.Linear(dim, dim * hidden_mult, **kw)
        self.down = nn.Linear(dim * hidden_mult, dim, **kw)
        #: set by `models.train.shard_params`: the mesh whose "tp" axis
        #: splits the hidden dim of both weights, and their names
        self.tp_mesh, self.tp_split = None, frozenset()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.tp_split:
            return self.down(F.gelu(self.up(x), approximate="tanh"))
        # column-parallel up, row-parallel down, summed in float32
        mesh = self.tp_mesh
        h = F.gelu(F.linear(tp_copy(x, mesh, "tp"), self.up.weight),
                   approximate="tanh")
        return row_parallel_linear(h, self.down.weight, mesh, "tp")


class TransformerBlock(nn.Module):
    """One pre-norm block.  ``forward(x)`` returns ``(x, aux)`` and
    ``forward(x, cache)`` returns ``(x, cache, aux)``: ``aux`` is the
    MoE layer's load-balancing loss (None for a dense MLP), returned
    rather than kept on the module so that a recomputed block (remat)
    counts it once."""

    def __init__(self, dim: int, num_q_heads: int, num_kv_heads: int,
                 head_dim: int, *, causal: bool = True,
                 impl: str = "flash",
                 dtype: torch.dtype, window: int | None = None,
                 attn_sinks: int = 0, rope: bool = False,
                 rope_theta: float = 10000.0,
                 softcap: float | None = None,
                 moe_experts: int | None = None, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25,
                 cp_axis: str | None = None, cp_impl: str = "allgather",
                 tp_axis: str | None = None, ep_axis: str | None = None,
                 mesh=None, device):
        super().__init__()
        self.norm1 = RMSNorm(dim, dtype=dtype, device=device)
        self.attn = GQASelfAttention(
            dim, num_q_heads, num_kv_heads, head_dim, causal=causal,
            impl=impl, dtype=dtype, window=window, attn_sinks=attn_sinks,
            rope=rope, rope_theta=rope_theta, softcap=softcap,
            cp_axis=cp_axis, cp_impl=cp_impl, tp_axis=tp_axis, mesh=mesh,
            device=device)
        self.norm2 = RMSNorm(dim, dtype=dtype, device=device)
        self.mlp = (MoEMLP(dim, moe_experts, top_k=moe_top_k,
                           capacity_factor=moe_capacity_factor,
                           ep_axis=ep_axis, mesh=mesh, dtype=dtype,
                           device=device)
                    if moe_experts else MLP(dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, cache=None):
        attn_out = self.attn(self.norm1(x), cache)
        if cache is not None:
            attn_out, cache = attn_out
        x = x + attn_out
        mlp_out, aux = self.mlp(self.norm2(x)), None
        if isinstance(self.mlp, MoEMLP):
            mlp_out, aux = mlp_out
        x = x + mlp_out
        return (x, aux) if cache is None else (x, cache, aux)


class TinyDecoder(nn.Module):
    """Decoder-only LM: embed -> ``depth`` blocks -> norm -> logits.

    ``forward(tokens)`` runs the uncached causal forward (the flash
    kernel); ``forward(tokens, caches)`` with one cache per layer
    (`KVCache`, `RaggedKVCache`, `PagedKV`, `QuantKVCache`,
    `RollingKVCache` or the serving engine's `RaggedPagedStep`) runs a
    cached step and returns ``(logits, caches)``.  ``window`` makes
    every block sliding-window attention and ``attn_sinks`` adds
    StreamingLLM sinks, in serving and in training alike.
    ``moe_experts`` puts a top-``moe_top_k`` mixture of experts
    (`MoEMLP`) in place of every block's MLP; ``return_aux=True`` then
    also returns the sum of the blocks' load-balancing losses (0.0 for
    a dense model).  ``remat=True`` recomputes each block's activations
    in the backward pass (`torch.utils.checkpoint`), and is ignored on
    cached calls.  ``impl="xla"`` runs attention in PyTorch ops on the
    uncached and dense-cache paths (a baseline; `ATTN_IMPLS`).

    ``cp_axis`` (an axis of ``mesh``, a `parallel.mesh.Mesh`) trains
    context-parallel: the uncached forward takes this rank's block of
    the sequence, ``tokens`` (B, S / sp) at global positions index · S /
    sp, and attention runs ``cp_impl`` ("allgather", "ring", "zigzag" or
    "ulysses"; `attention_layer.CP_IMPLS`) over the axis;
    `models.train.make_train_step` cuts the blocks.

    ``tp_axis`` (an axis of ``mesh``) serves tensor-parallel, as JAX's
    ``tp_axis`` does: every parameter stays whole on every rank, each
    cached call runs this rank's block of ``num_kv_heads / tp`` kv heads
    (and the q heads that read them) through the kernels and gathers
    the heads' output, so every rank computes the same logits;
    `init_caches` (and the engine's pools) hold only the rank's block.
    Every generate function, beam search and speculative decoding run
    on such a model; the uncached forward is the single-device one, or
    ``cp_axis``'s, which may share the mesh.

    ``ep_axis`` (an axis of ``mesh``, JAX's `ValueError` if the mesh
    lacks it) splits each MoE layer's experts over that axis (`MoEMLP`);
    the trainer splits them over "tp" in any case (`shard_params`).  A
    mixture of experts trains on any mesh, ``cp_axis`` included, with
    JAX's global capacity, slots and aux loss."""

    def __init__(self, vocab: int = 256, dim: int = 256, depth: int = 2,
                 num_q_heads: int = 8, num_kv_heads: int = 2,
                 impl: str = "flash", dtype: torch.dtype = torch.bfloat16,
                 window: int | None = None, attn_sinks: int = 0,
                 rope: bool = False, rope_theta: float = 10000.0,
                 softcap: float | None = None, remat: bool = False,
                 moe_experts: int | None = None, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25,
                 cp_axis: str | None = None, cp_impl: str = "allgather",
                 tp_axis: str | None = None, ep_axis: str | None = None,
                 mesh=None, device: str | torch.device = "cuda"):
        # every constructor argument but the device: what `clone` rebuilds
        config = {name: value for name, value in locals().items()
                  if name in _CLONED_PARAMS}
        super().__init__()
        check_impl(impl)
        self._config = config
        device = resolve_device(device)
        self.vocab = vocab
        self.dim = dim
        self.depth = depth
        self.num_q_heads = num_q_heads
        self.num_kv_heads = num_kv_heads
        self.impl = impl
        self.dtype = dtype
        self.window = window
        self.attn_sinks = attn_sinks
        self.rope = rope
        self.softcap = softcap
        self.remat = remat
        self.moe_experts = moe_experts
        self.cp_axis, self.cp_impl, self.mesh = cp_axis, cp_impl, mesh
        self.tp_axis, self.ep_axis = tp_axis, ep_axis
        #: set by `models.train.shard_params`: the trainer's `ParamLayout`,
        #: the mesh whose "tp" axis splits the embedding's and the head's
        #: vocab, and which of the two it splits
        self.layout = None
        self.tp_mesh, self.tp_split = None, frozenset()
        self.head_dim = dim // num_q_heads
        self.embed = nn.Embedding(vocab, dim, dtype=dtype, device=device)
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, num_q_heads, num_kv_heads, self.head_dim,
                             impl=impl, dtype=dtype, window=window,
                             attn_sinks=attn_sinks, rope=rope,
                             rope_theta=rope_theta, softcap=softcap,
                             moe_experts=moe_experts, moe_top_k=moe_top_k,
                             moe_capacity_factor=moe_capacity_factor,
                             cp_axis=cp_axis, cp_impl=cp_impl,
                             tp_axis=tp_axis, ep_axis=ep_axis, mesh=mesh,
                             device=device)
            for _ in range(depth))
        self.norm = RMSNorm(dim, dtype=dtype, device=device)
        self.head = nn.Linear(dim, vocab, bias=False, dtype=torch.float32,
                              device=device)

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def clone(self, **overrides) -> "TinyDecoder":
        """This model's configuration with ``overrides`` (JAX's
        ``Module.clone``), sharing this model's parameters, not copying
        them: the serving engine's step model on a mesh (``tp_axis=``,
        ``mesh=``)."""
        twin = TinyDecoder(**{**self._config, **overrides}, device="meta")
        twin.load_state_dict(self.state_dict(keep_vars=True), assign=True)
        return twin

    @property
    def kv_heads_local(self) -> int:
        """The kv heads of this rank's caches and pools: all of them,
        or its block of ``num_kv_heads / tp`` under ``tp_axis``."""
        if self.tp_axis is None:
            return self.num_kv_heads
        return self.num_kv_heads // self.mesh.shape[self.tp_axis]

    def forward(self, tokens: torch.Tensor, caches=None,
                return_aux: bool = False):
        h, new_caches, aux = self.features(tokens, caches)
        if "head.weight" in self.tp_split:
            mesh = self.tp_mesh
            logits = gather_whole(
                F.linear(tp_copy(h, mesh, "tp"), self.head.weight), mesh,
                "tp", -1)
        else:
            logits = self.head(h)
        out = logits if caches is None else (logits, new_caches)
        return (out, aux) if return_aux else out

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        if "embed.weight" not in self.tp_split:
            return self.embed(tokens)
        # vocab-parallel: this rank's rows looked up, the rest zero, the
        # ranks' rows summed (exactly: one of them is not zero)
        mesh, w = self.tp_mesh, self.embed.weight
        local = tokens - mesh.index("tp") * w.shape[0]
        inside = (local >= 0) & (local < w.shape[0])
        rows = F.embedding(local.clamp(0, w.shape[0] - 1), w)
        return tp_reduce(torch.where(inside[..., None], rows, 0), mesh, "tp")

    def features(self, tokens: torch.Tensor, caches=None):
        """(the final norm's output in float32 (B, S, D), the new caches
        (a tuple; empty on an uncached call), the sum of the blocks' MoE
        aux losses): the forward up to the logits head."""
        x = self._embed(tokens)
        new_caches, aux = [], 0.0
        for i, block in enumerate(self.blocks):
            if caches is None:
                if self.remat:
                    x, block_aux = checkpoint(block, x, use_reentrant=False)
                else:
                    x, block_aux = block(x)
            else:
                x, c, block_aux = block(x, caches[i])
                new_caches.append(c)
            if block_aux is not None:
                aux = aux + block_aux
        return self.norm(x).float(), tuple(new_caches), aux

    def init_caches(self, batch: int, capacity: int,
                    cache_dtype: torch.dtype | None = None,
                    rolling: bool = False) -> tuple:
        """Fresh per-layer dense `KVCache`s of ``capacity`` rows on the
        model's device, in ``cache_dtype`` (default: the model's), over
        `kv_heads_local` heads.  ``rolling=True`` (windowed models only)
        gives ring-buffer `RollingKVCache`s instead, whose memory is
        bounded by the window and the sinks, not by ``capacity``."""
        if rolling:
            if self.window is None:
                raise ValueError("rolling caches require a windowed model")
            return tuple(
                RollingKVCache.create(batch, self.kv_heads_local, self.window,
                                      self.head_dim,
                                      cache_dtype or self.dtype,
                                      self.device, sinks=self.attn_sinks)
                for _ in range(self.depth))
        return tuple(
            KVCache.create(batch, self.kv_heads_local, capacity,
                           self.head_dim, cache_dtype or self.dtype,
                           self.device)
            for _ in range(self.depth))


#: the `TinyDecoder` constructor's arguments that `TinyDecoder.clone`
#: carries over: all but the device (a clone shares the parameters)
_CLONED_PARAMS = frozenset(inspect.signature(TinyDecoder).parameters) \
    - {"device"}


def _fan_in(name: str, shape: torch.Size) -> int:
    """A weight's fan-in: a ``Linear``'s or embedding's last axis, an
    expert tensor's (E, in, out) middle one."""
    if name.endswith(("experts_up", "experts_down")):
        return shape[1]
    return shape[-1]


def init_params(model: TinyDecoder, seed: int,
                dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """A seeded random ``state_dict`` for ``model``, drawn on its device
    (the card has no JAX, so the port makes its own weights): normal
    weights with std 1/sqrt(fan_in) (embedding: 1/sqrt(dim)), norm
    scales 1, in ``dtype`` (default: each parameter's own; float32 gives
    a trainer's unrounded masters).  Load it with
    ``model.load_state_dict``."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    params = {}
    for name, p in model.state_dict().items():
        if name.endswith("scale"):
            params[name] = torch.ones_like(p, dtype=dtype)
            continue
        w = torch.randn(p.shape, generator=gen, device=p.device,
                        dtype=torch.float32) / _fan_in(name, p.shape) ** 0.5
        params[name] = w.to(dtype or p.dtype)
    return params

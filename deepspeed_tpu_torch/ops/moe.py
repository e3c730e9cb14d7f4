"""Mixture-of-Experts with expert parallelism over the data axis.

Port of deepspeed_tpu/ops/moe.py. The router is the JAX package's GShard
top-k gating (:func:`top_k_gating`): a float32 softmax over the experts,
the Switch load-balancing loss ``E * mean_g sum_e(mean-gate_e *
first-choice fraction_e)``, a fill count per expert carried across the k
choices, ``capacity = max(1, int(capacity_factor * S * k / E))`` slots a
group and expert, a token whose slot is not below the capacity falls
through to the residual, and for k > 1 the kept gates divided by
``max(sum of the k chosen gates, 1e-9)``. The JAX layer builds one-hot
``[G, S, E, C]`` dispatch and combine tensors for GSPMD; the port keeps
the same routing as indices (:class:`Routing`: each choice's expert, its
slot and its combine weight) and moves the tokens by index: the dispatch
writes each kept token's row into its expert's slot and the combine
gathers it back, weighted. The dispatch, the combine weights and their
gradient into ``gate_w`` are the JAX layer's; nothing ``[G, S, E, C]``
is formed.

Expert parallelism (the JAX package's expert axis = data): a data rank
holds ``E / dp`` experts, ``expert_*[r*E/dp:(r+1)*E/dp]``. A row of the
batch is one group, so the routing never depends on dp. The expert
queues ``[E, G_local, C, M]`` go through one all-to-all over the data
group (parallel/sequence.py's exchange, whose backward is the inverse
exchange) and arrive as ``[E/dp, dp*G_local, C, M]``: every rank's
groups for this rank's experts; the expert outputs go back the same way.
A rank's expert gradients therefore already hold every rank's tokens
(the training engine does not reduce them over the data group), while
``gate_w`` is replicated and reduced like any dense parameter.

The expert products are ``torch.baddbmm`` (the JAX layer leaves them to
XLA; no TPU kernel is on this path). :class:`DeepSpeedMoETransformerLayer`
is the transformer block with this FFN in place of the dense one
(ops/transformer.py:transformer_block_apply's ``ffn_fn``): it returns
``(hidden, aux_loss_weight * aux)``.
"""

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.sequence import _AllToAll
from ..runtime import dist as dist_lib

#: The expert-stacked tensors (sharded over the expert axis); the router's
#: ``gate_w`` is replicated.
EXPERT_TENSORS = ("expert_in_w", "expert_in_b", "expert_out_w",
                  "expert_out_b")


@dataclasses.dataclass(unsafe_hash=True)
class MoEConfig:
    """The JAX layer's MoE settings; the experts always shard over the
    data axis (the JAX package's default ``expert_axis``)."""

    n_experts: int = 8
    # top-k routing (1 = Switch, 2 = GShard default)
    top_k: int = 2
    capacity_factor: float = 1.25
    # weight of the load-balancing aux loss the layer returns
    aux_loss_weight: float = 1e-2


def expert_capacity(cfg, tokens):
    """Slots a group gives each expert: ``max(1, int(capacity_factor *
    tokens * top_k / n_experts))``, truncated as Python truncates a
    float, as the JAX layer computes it."""
    return max(1, int(cfg.capacity_factor * tokens * cfg.top_k
                      / cfg.n_experts))


@dataclasses.dataclass
class Routing:
    """The routing of ``[G, S]`` tokens, one entry per choice ``k``:
    ``expert`` [G, S, K] (int64), ``slot`` [G, S, K] (its position in the
    expert's queue; ``capacity`` when dropped), ``keep`` [G, S, K],
    ``weight`` [G, S, K] float32 (the combine weight, 0 where dropped;
    differentiable into the logits), ``aux`` (the load-balancing loss, a
    float32 scalar) and ``capacity``."""

    expert: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    weight: torch.Tensor
    aux: torch.Tensor
    capacity: int


def route(logits, k, capacity):
    """GShard top-k gating of ``logits`` [G, S, E] as indices
    (:class:`Routing`)."""
    G, S, E = logits.shape
    gates = torch.softmax(logits.float(), dim=-1)
    # the aux loss reads the FIRST choice (Switch eq. 4)
    top1 = F.one_hot(gates.argmax(dim=-1), E).float()
    aux = E * torch.mean(torch.sum(gates.mean(dim=1) * top1.mean(dim=1),
                                   dim=-1))
    remaining = gates
    fill = torch.zeros(G, E, dtype=torch.int64, device=logits.device)
    topk_mass = torch.zeros(G, S, dtype=torch.float32, device=logits.device)
    experts, slots, keeps, gate_vals = [], [], [], []
    for _ in range(k):
        choice = remaining.argmax(dim=-1)  # [G, S]; ties: the first
        onehot = F.one_hot(choice, E)  # int64
        gate_val = torch.gather(remaining, -1, choice[..., None])[..., 0]
        # earlier tokens of the group claim earlier slots, after the
        # slots earlier choices filled
        before = torch.cumsum(onehot, dim=1) - onehot
        pos = torch.gather(before, -1, choice[..., None])[..., 0]
        pos = pos + torch.gather(fill, 1, choice)
        keep = pos < capacity
        fill = fill + (onehot * keep[..., None]).sum(dim=1)
        topk_mass = topk_mass + gate_val
        remaining = remaining * (1.0 - onehot.float())
        experts.append(choice)
        slots.append(torch.where(keep, pos, torch.full_like(pos, capacity)))
        keeps.append(keep)
        gate_vals.append(gate_val)
    keep = torch.stack(keeps, dim=-1)
    weight = torch.where(keep, torch.stack(gate_vals, dim=-1),
                         torch.zeros((), device=logits.device))
    if k > 1:
        weight = weight / torch.clamp(topk_mass, min=1e-9)[..., None]
    return Routing(torch.stack(experts, dim=-1), torch.stack(slots, dim=-1),
                   keep, weight, aux, capacity)


def top_k_gating(logits, k, capacity):
    """The JAX layer's outputs from :func:`route`: ``(dispatch, combine,
    aux)``, dispatch and combine one-hot ``[G, S, E, C]`` float32 (what
    the tests hold against the JAX package; the layer itself uses the
    indices)."""
    G, S, E = logits.shape
    r = route(logits, k, capacity)
    # a dropped choice's slot is ``capacity``: one past the last column,
    # cut off below
    slot_1h = F.one_hot(r.slot, capacity + 1)[..., :capacity].float()
    exp_1h = F.one_hot(r.expert, E).float()
    d = exp_1h[..., :, None] * slot_1h[..., None, :]  # [G, S, K, E, C]
    dispatch = d.sum(dim=2)
    combine = (d * r.weight[..., None, None]).sum(dim=2)
    return dispatch, combine, r.aux


def _slot_rows(r, n_experts):
    """Each choice's row of the flat expert queues ``[E * G * C]``: ``(e
    * G + g) * C + slot``, and one past the last row for a dropped one."""
    G, S, K = r.expert.shape
    C = r.capacity
    g = torch.arange(G, device=r.expert.device)[:, None, None]
    rows = (r.expert * G + g) * C + r.slot
    return torch.where(r.keep, rows,
                       torch.full_like(rows, n_experts * G * C))


class _GatherRows(torch.autograd.Function):
    """A sequence line's chunks of ``[G, Sl, M]`` joined along dim 1 in
    sequence order; the backward sums every rank's gradient of the whole
    row and keeps this rank's chunk (each rank's computation over the
    whole row may reach every token)."""

    @staticmethod
    def forward(ctx, x, line):
        ctx.line = line
        x = x.contiguous()
        buf = torch.empty((line.size,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        dist_lib.all_gather(buf.view(-1), x.reshape(-1), line.group)
        return torch.cat(list(buf), dim=1)

    @staticmethod
    def backward(ctx, g):
        line = ctx.line
        g = g.contiguous().clone()
        dist_lib.all_reduce(g, line.group)
        return g.chunk(line.size, dim=1)[line.rank].contiguous(), None


def _line_share(aux, line):
    """``aux`` in value, its gradient divided by the line's size: every
    rank of a sequence line computes the whole rows' router loss, and the
    line's sum of their gradients is its gradient once."""
    share = aux / line.size
    return share + (aux - share).detach()


def moe_apply(cfg, p, x, line=None, seq_line=None):
    """The expert FFN over ``x`` [G, S, M] with the parameters of ``p``
    (an :class:`MoEMLP`, or a module whose tensors ``functional_call``
    swapped in): ``(y [G, S, M], aux_loss_weight * aux)``. ``line`` (a
    data-axis line, parallel/sequence.py's ``SequenceParallel`` form)
    holds ``E / line.size`` experts a rank; None holds them all. At a
    sequence line ``seq_line`` (``x`` a rank's chunk of each row) the rows
    are routed whole, as the JAX layer routes the global row: the chunks
    are gathered over the line, every rank routes and runs the whole rows,
    and keeps its chunk of the output."""
    if seq_line is not None:
        y, aux = moe_apply(cfg, p, _GatherRows.apply(x, seq_line), line)
        return (y.chunk(seq_line.size, dim=1)[seq_line.rank],
                _line_share(aux, seq_line))
    G, S, M = x.shape
    E = cfg.n_experts
    dp = 1 if line is None else line.size
    capacity = expert_capacity(cfg, S)
    logits = x.float() @ p.gate_w.float()  # the router in float32
    r = route(logits, cfg.top_k, capacity)
    rows = _slot_rows(r, E).reshape(-1)
    src = x.reshape(G * S, 1, M).expand(G * S, cfg.top_k, M).reshape(-1, M)
    # tokens -> expert queues (a dropped choice lands on a spare row)
    queues = x.new_zeros(E * G * capacity + 1, M).index_copy(0, rows, src)
    queues = queues[:-1].view(E, G, capacity, M)
    if dp > 1:
        queues = _AllToAll.apply(queues, line, 0, 1)  # [E/dp, dp*G, C, M]
    local = queues.shape[0]
    flat = queues.reshape(local, -1, M)
    h = F.gelu(torch.baddbmm(p.expert_in_b[:, None, :].to(x.dtype), flat,
                             p.expert_in_w.to(x.dtype)),
               approximate="tanh")
    out = torch.baddbmm(p.expert_out_b[:, None, :].to(x.dtype), h,
                        p.expert_out_w.to(x.dtype))
    out = out.view(queues.shape)
    if dp > 1:
        out = _AllToAll.apply(out, line, 1, 0)  # [E, G, C, M]
    # expert queues -> tokens, weighted (the JAX layer's combine is cast
    # to x's dtype); a dropped choice reads the zero row
    out = torch.cat([out.reshape(-1, M), out.new_zeros(1, M)])
    picked = out.index_select(0, rows).view(G, S, cfg.top_k, M)
    y = torch.einsum("gsk,gskm->gsm", r.weight.to(x.dtype), picked)
    return y, cfg.aux_loss_weight * r.aux


class MoEMLP(nn.Module):
    """The expert-parallel FFN's parameters: ``gate_w`` [M, E] float32,
    ``expert_in_w`` [E, M, I], ``expert_in_b`` [E, I], ``expert_out_w``
    [E, I, M], ``expert_out_b`` [E, M] (the JAX layer's orientation; E is
    this rank's experts once :meth:`configure_expert_parallel` cut them).
    ``forward(x)`` is :func:`moe_apply`."""

    def __init__(self, hidden, intermediate, cfg, device=None,
                 dtype=torch.float32, initializer_range=0.02):
        super().__init__()
        self.cfg = cfg
        self.initializer_range = initializer_range
        E, M, I = cfg.n_experts, hidden, intermediate
        self.gate_w = nn.Parameter(torch.empty(M, E, device=device,
                                               dtype=torch.float32))
        for name, shape in (("expert_in_w", (E, M, I)),
                            ("expert_in_b", (E, I)),
                            ("expert_out_w", (E, I, M)),
                            ("expert_out_b", (E, M))):
            setattr(self, name, nn.Parameter(torch.empty(
                shape, device=device, dtype=dtype)))
        self.line = None

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """N(0, initializer_range) weights and zero biases: the JAX layer's
        initializers (not its random stream)."""
        for name in ("gate_w", "expert_in_w", "expert_out_w"):
            getattr(self, name).normal_(0.0, self.initializer_range,
                                        generator=generator)
        self.expert_in_b.zero_()
        self.expert_out_b.zero_()

    @torch.no_grad()
    def configure_expert_parallel(self, line):
        """Keep this rank's ``E / line.size`` experts (``line``: the data
        axis's line; None or size 1 keeps them all) and exchange tokens
        over it."""
        if line is None or line.size <= 1:
            self.line = None
            return
        E = self.cfg.n_experts
        if E % line.size:
            raise ValueError(
                f"moe_experts={E} must divide over the expert axis "
                f"(data) of {line.size}")
        if self.expert_in_w.shape[0] == E:
            k = E // line.size
            for name in EXPERT_TENSORS:
                p = getattr(self, name)
                p.data = p.data[line.rank * k:(line.rank + 1) * k].clone()
        self.line = line

    def forward(self, x):
        return moe_apply(self.cfg, self, x, self.line)


class DeepSpeedMoETransformerLayer(nn.Module):
    """A transformer block whose FFN is an expert-parallel MoE: the
    attention and norm tensors of the block layout (``attn_*``,
    ``norm_w``/``norm_b``; no ``inter_*``/``output_*``) and ``moe`` (an
    :class:`MoEMLP`). :func:`moe_block_apply` runs it and returns
    ``(hidden, aux)``. The memory modes are refused, as the JAX layer
    refuses them."""

    def __init__(self, config, moe, device=None, dtype=torch.float32):
        super().__init__()
        from .transformer import TRANSFORMER_PARAM_LAYOUT

        if config.use_remat:
            raise ValueError(
                "DeepSpeedMoETransformerLayer does not support the layer "
                "memory modes; leave remat flags off for MoE layers"
            )
        self.config = config
        dims = {"H": config.hidden_size, "3H": 3 * config.hidden_size}
        self._layout = [(n, s, kind) for n, s, kind in TRANSFORMER_PARAM_LAYOUT
                        if not n.startswith(("inter_", "output_"))]
        for name, shape, _ in self._layout:
            setattr(self, name, nn.Parameter(torch.empty(
                tuple(dims[d] for d in shape), device=device, dtype=dtype)))
        self.moe = MoEMLP(config.hidden_size, config.intermediate, moe,
                          device, dtype, config.initializer_range)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        for name, _, kind in self._layout:
            p = getattr(self, name)
            if kind == "normal":
                p.normal_(0.0, self.config.initializer_range,
                          generator=generator)
            elif kind == "ones":
                p.fill_(1.0)
            else:
                p.zero_()
        self.moe.reset_parameters(generator)

    def reset_lora_parameters(self, generator=None):
        """No LoRA factors on an MoE block (the adapters block refuses
        MoE)."""
        del generator


def moe_block_apply(cfg, p, hidden_states, attention_mask=None, *,
                    causal=False, train=False, dropout_rng=None,
                    use_flash=True):
    """The MoE block over ``p`` (a :class:`DeepSpeedMoETransformerLayer`):
    ``(hidden, aux)``, the dense block's attention, norms, dropouts and
    residuals with the MoE FFN in place of the dense one."""
    from .transformer import transformer_block_apply

    moe = p.moe
    seq_line = cfg.sequence_parallel
    if seq_line is not None and seq_line.size <= 1:
        seq_line = None
    return transformer_block_apply(
        cfg, p, hidden_states, attention_mask, causal=causal, train=train,
        dropout_rng=dropout_rng, use_flash=use_flash,
        ffn_fn=lambda ff_in: moe_apply(moe.cfg, moe, ff_in, moe.line,
                                       seq_line))

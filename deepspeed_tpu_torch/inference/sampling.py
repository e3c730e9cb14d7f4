"""Token sampling: greedy / temperature / top-k / top-p.

Port of deepspeed_tpu/inference/sampling.py: one function over
``[slots, vocab_padded]`` logits. Per-slot ``temperature`` rides as a
tensor (``<= 0`` means greedy for that slot), so greedy and sampled
requests share a batch; ``top_k``/``top_p``/vocab size are engine-wide.
Randomness comes from an explicit ``torch.Generator`` (the JAX package
threads a PRNG key); the two give different samples from the same seed,
so only the greedy path is comparable across packages.
"""

import torch

from ..ops.attention import NEG_INF


def mask_padded_vocab(logits, vocab_size):
    """Kill the padding vocab columns (models pad vocab to a multiple of
    128; those rows of wte are random init, and argmax over them would
    emit unreal token ids)."""
    if logits.shape[-1] == vocab_size:
        return logits
    idx = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(idx < vocab_size, logits, NEG_INF)


def _apply_top_k(logits, top_k):
    """Keep the k highest logits per row; the rest -> NEG_INF."""
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits >= kth, logits, NEG_INF)


def _apply_top_p(logits, top_p):
    """Nucleus filtering: keep the smallest prefix of the
    probability-sorted vocab whose mass reaches ``top_p`` (the
    highest-probability token always survives — the exclusive cumsum
    guarantees it)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs  # exclusive
    kept = torch.where(cum < top_p, sorted_logits, torch.inf)
    threshold = kept.amin(dim=-1, keepdim=True)
    return torch.where(logits >= threshold, logits, NEG_INF)


def sample_tokens(logits, generator, temperature, *, vocab_size, top_k=0,
                  top_p=1.0):
    """Sample one token per row. ``logits`` [slots, vocab_padded],
    ``generator`` a ``torch.Generator`` on the logits' device,
    ``temperature`` [slots] (<= 0 -> greedy for that row). ``top_k=0`` /
    ``top_p=1.0`` disable the respective filter. Returns [slots] int32."""
    logits = mask_padded_vocab(logits.float(), vocab_size)
    greedy_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    temperature = torch.as_tensor(
        temperature, dtype=torch.float32, device=logits.device
    )
    sampled_rows = temperature > 0
    if not bool(sampled_rows.any()):
        return greedy_tokens
    safe_t = torch.where(sampled_rows, temperature, 1.0)
    scaled = logits / safe_t[:, None]
    if top_k and top_k < vocab_size:
        scaled = _apply_top_k(scaled, int(top_k))
    if top_p < 1.0:
        scaled = _apply_top_p(scaled, float(top_p))
    probs = torch.softmax(scaled, dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(sampled_rows, sampled.to(torch.int32), greedy_tokens)

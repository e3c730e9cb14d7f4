"""Kernel autotuning: empirical tile selection for the flash forward.

The port of the JAX package's ``ops/autotune.py`` (itself the analogue
of the reference's GEMM autotuner, csrc/includes/gemm_test.h, which
sweeps ``cublasGemmAlgo_t`` and keeps the fastest). cuBLAS picks its own
GEMM algorithms, so the hand-scheduled choice left is the flash
forward's tile form: ``csrc/flash_fwd.cu`` has 128- and 64-key K/V tiles
at head dims 64 and 128 (:func:`~.attention.flash_block_forms`). The
backward keeps one form a head dim.

Use offline (results are cached per shape, causal, dtype, candidates,
``include_backward`` and device name)::

    from deepspeed_tpu_torch.ops.autotune import autotune_flash_blocks
    (bq, bk), table = autotune_flash_blocks(batch=8, heads=12, seq=1024,
                                            head_dim=64, causal=True)
    out = flash_attention(q, k, v, causal=True, block_q=bq, block_k=bk)

On the card each candidate's forward is timed on the device's clock,
after a warm-up: ``steps`` calls back to back between one pair of CUDA
events, behind a spin that outlasts the host's enqueue of them, so that
the events time the kernels alone; the candidates take turns for
``ROUNDS`` such readings and each keeps its median. The forward is all
the choice changes: with ``include_backward`` the backward (one form) is
read the same way and its median added to every entry, so the table
reads a fwd + bwd step as the JAX package's does. With ``device="cpu"``
the plain version (which has no tiles) runs fwd (+ bwd) for every
candidate that tiles ``seq``, timed on the host clock.
"""

import statistics
import time

import torch

_CACHE = {}

#: The forward's tensor-core forms at head dims 64 and 128.
DEFAULT_CANDIDATES = ((128, 128), (128, 64))

#: The spin queued ahead of a reading on the card, per call read
#: (``torch.cuda._sleep`` cycles, ~1 ms on an H100): it must outlast the
#: host's enqueue of the reading's calls.
SPIN_CYCLES_PER_CALL = 2_000_000

#: Readings per candidate on the card (the median is kept).
ROUNDS = 5


def _device_name(device):
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _card_seconds(fn, calls):
    """Seconds a call of ``fn`` on the card's clock: ``calls`` calls back
    to back behind a spin."""
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES_PER_CALL * calls)
    begin.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return begin.elapsed_time(end) / 1e3 / calls


def _time_on_card(q, k, v, causal, kept, steps, include_backward):
    """{blocks: seconds}: each kept form's forward, its median over
    ``ROUNDS`` interleaved readings, plus the backward's median."""
    from .attention import flash_attention

    def forward(blocks):
        with torch.no_grad():
            return flash_attention(q, k, v, causal=causal, block_q=blocks[0],
                                   block_k=blocks[1])

    for blocks in kept:
        forward(blocks)  # warm-up: the build, the first launch
    times = {blocks: [] for blocks in kept}
    for _ in range(ROUNDS):
        for blocks in kept:
            times[blocks].append(_card_seconds(lambda: forward(blocks),
                                               steps))
    backward = 0.0
    if include_backward:
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        out = flash_attention(qs, ks, vs, causal=causal)
        dout = torch.ones_like(out)
        out.backward(dout, retain_graph=True)  # warm-up
        backward = statistics.median(_card_seconds(
            lambda: out.backward(dout, retain_graph=True), steps)
            for _ in range(ROUNDS))
    return {blocks: statistics.median(t) + backward
            for blocks, t in times.items()}


def _time_on_host(q, k, v, causal, kept, steps, include_backward):
    """{blocks: seconds per fwd (+ bwd)} of the plain version on the
    host's clock (it has no tiles: the filtering, clamping and cache
    run as on the card)."""
    from .attention import flash_attention

    def run():
        if not include_backward:
            with torch.no_grad():
                return flash_attention(q, k, v, causal=causal)
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        (flash_attention(qs, ks, vs, causal=causal) ** 2).sum().backward()
        return qs.grad, ks.grad, vs.grad

    results = {}
    for blocks in kept:
        run()  # warm-up
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        results[blocks] = (time.perf_counter() - t0) / steps
    return results


def autotune_flash_blocks(
    batch, heads, seq, head_dim, *, causal=False, dtype=torch.bfloat16,
    candidates=DEFAULT_CANDIDATES, steps=5, include_backward=True,
    device=None,
):
    """Time fwd (+bwd) of the flash attention for each ``(block_q,
    block_k)`` and return ``((best_bq, best_bk), {blocks:
    seconds_per_step})``.

    Candidates that do not tile ``seq`` (after clamping to it) are
    skipped, clamped duplicates are timed once, and on the card a
    candidate the kernels have no form for is skipped (as the JAX package
    skips a VMEM rejection); ``RuntimeError`` if none is left. Like
    gemm_test.h this measures the real kernels on the real device: run it
    once offline, not in the training loop. ``device`` defaults to the
    current CUDA device."""
    from .attention import flash_block_forms

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (batch, heads, seq, head_dim, causal, str(dtype),
           tuple(candidates), include_backward, _device_name(device))
    if key in _CACHE:
        return _CACHE[key]

    forms = (flash_block_forms(dtype, head_dim) if device.type == "cuda"
             else None)
    kept = []
    for bq, bk in candidates:
        blocks = (min(bq, seq), min(bk, seq))
        if seq % blocks[0] or seq % blocks[1]:
            continue
        if blocks in kept:
            continue  # clamped duplicates: don't re-time the same form
        if forms is not None and blocks not in forms:
            continue  # no kernel of this form
        kept.append(blocks)
    if not kept:
        raise RuntimeError(
            f"no flash block candidate has a form for seq={seq} "
            f"(candidates {candidates})"
        )

    gen = torch.Generator().manual_seed(0)
    shape = (batch, heads, seq, head_dim)
    q, k, v = ((torch.randn(shape, generator=gen) * 0.5).to(device, dtype)
               for _ in range(3))
    timing = _time_on_card if device.type == "cuda" else _time_on_host
    results = timing(q, k, v, causal, kept, steps, include_backward)
    best = min(results, key=results.get)
    _CACHE[key] = (best, results)
    return best, results

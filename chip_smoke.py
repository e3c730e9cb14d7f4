"""Chip smoke test for the PyTorch/CUDA port (deepspeed_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. probe   — require CUDA; print the card's name and power limit.
  2. build   — compile every CUDA kernel of the slice from csrc/ (one nvcc
               per source, all started together) and print the seconds.
  3. kernels — each kernel against its plain PyTorch version on the same
               inputs, float32 and bfloat16, at the serving path's shapes
               (plus a key-mask case, a fully masked row, a dead slot and
               a NULL page mid-table), with the tolerances below; then
               each kernel's time beside its plain version's, one PyTorch
               library call's where there is one, and its bound.
  4. slice   — init_inference on GPT-2 small (random weights from --seed,
               bf16, paged KV, fused decode): 4 mixed-length prompts and
               a 5th that hits the prefix cache, 32 new tokens each. Both
               kernels' launch counters must move on this run (flash >= 12
               per cold prefill, decode >= 12 per decode step). Then the
               same requests in float32 with fused decode on and off must
               give identical greedy tokens, and the float32 engine's first
               token must match the model's full forward on the prompt.
               Last, torch.profiler over a warm bf16 run: device time by
               kernel and the device's idle share.
  5. report  — a JSON line of per-kernel numbers, the nvidia-smi line,
               then the last line {"ok": true, "device": {...}}.

Tolerances: float32 kernel vs plain atol = rtol = 1e-4 (same float32
arithmetic in another summation order; observed errors sit near 1e-6);
bfloat16 atol = rtol = 1e-2 (both round p and the output to bfloat16, at
different points of the online softmax: one bf16 ulp of an output in
[1, 2) is 7.8e-3, and rtol 1e-2 covers one ulp at any magnitude).
"""

import argparse
import json
import subprocess
import sys
import time

import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {  # dense, H100 SXM at 700 W (NVIDIA data sheet)
    torch.bfloat16: 989e12,  # tensor cores
    torch.float32: 67e12,    # outside the tensor cores
}
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
N_LAYER = 12
FLASH_SOURCE = "deepspeed_tpu_torch/csrc/flash_fwd.cu"
DECODE_SOURCE = "deepspeed_tpu_torch/csrc/paged_decode.cu"
FLASH_TPU = "deepspeed_tpu/ops/attention.py:140"
DECODE_TPU = "deepspeed_tpu/ops/decode_attention.py:66"


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------
class Timer:
    """CUDA-event time of one call, averaged over ``iters`` calls, with the
    50 MB L2 flushed before each (the serving path finds the next layer's
    K/V cold)."""

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, want, dtype):
    tol = TOL[dtype]
    err = max_err(got, want)
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
    log(f"  {name}: max_abs_err {err:.3e} (tol {tol:g}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain
# ---------------------------------------------------------------------------
def flash_cases(device, gen):
    b, h, s, d = 1, 12, 1024, 64
    def qkv(batch):
        return [torch.randn(batch, h, s, d, device=device, generator=gen)
                for _ in range(3)]
    masked = torch.ones(2, s, dtype=torch.int32, device=device)
    masked[1, 700:] = 0
    dead = torch.ones(2, s, dtype=torch.int32, device=device)
    dead[1] = 0
    return [
        ("causal", qkv(b), None, True),
        ("causal+kv_mask", qkv(2), masked, True),
        ("fully_masked_row", qkv(2), dead, False),
    ]


def flash_work(q, kv_mask, causal):
    """Bytes and flops the function needs on these inputs: q, k, v (and
    the mask) read once, out and lse written once; 4*D flops per visible
    (query, key) pair."""
    b, h, sq, d = q.shape
    sk = sq
    es = q.element_size()
    nbytes = (4 * b * h * sq * d) * es + b * h * sq * 4
    i = torch.arange(sq, device=q.device)[:, None]
    j = torch.arange(sk, device=q.device)[None, :]
    vis = (j <= i) if causal else torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        nbytes += kv_mask.numel() * 4
        pairs = int((vis[None] & (kv_mask[:, None, :] != 0)).sum()) * h
    else:
        pairs = int(vis.sum()) * b * h
    return nbytes, 4 * d * pairs


def decode_case(device, gen, dtype):
    """The serving path's decode shape: 8 slots x 12 heads x hd 64, pages of
    16 tokens, 64 pages per slot (max_seq_len 1024), the pool sized as the
    engine sizes it (8 * 64 pages + the NULL page). Mixed positions, slot 3
    dead, slot 5 with the NULL page at logical page 3."""
    slots, heads, hd, bs, mb = 8, 12, 64, 16, 64
    pages = slots * mb + 1
    q = torch.randn(slots, heads, hd, device=device, generator=gen).to(dtype)
    kp = torch.randn(pages, bs, heads, hd, device=device, generator=gen).to(dtype)
    vp = torch.randn(pages, bs, heads, hd, device=device, generator=gen).to(dtype)
    perm = torch.randperm(pages - 1, device=device, generator=gen) + 1
    tables = perm.reshape(slots, mb).to(torch.int32)
    tables[3] = 0
    tables[5, 3] = 0
    positions = torch.tensor(
        [15, 100, 1023, 0, 500, 257, 31, 700], dtype=torch.int32, device=device
    )
    return q, kp, vp, tables.contiguous(), positions


def decode_work(q, tables, positions, block_size):
    slots, heads, hd = q.shape
    es = q.element_size()
    live = 0
    tab = tables.cpu()
    for b, pos in enumerate(positions.tolist()):
        for j in range(min(tab.shape[1], pos // block_size + 1)):
            if int(tab[b, j]) != 0:
                live += min(block_size, pos - j * block_size + 1)
    nbytes = (2 * live * heads * hd + 2 * slots * heads * hd) * es
    nbytes += tables.numel() * 4 + positions.numel() * 4
    return nbytes, 4 * hd * heads * live


def phase_kernels(device, seed):
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.attention import flash_fwd, flash_fwd_plain
    from deepspeed_tpu_torch.ops.decode_attention import (
        paged_flash_decode,
        paged_flash_decode_plain,
    )

    gen = torch.Generator(device=device).manual_seed(seed)
    timer = Timer(device)
    report = {}

    log("phase 3: flash_fwd vs plain")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, (q, k, v), kv_mask, causal in flash_cases(device, gen):
            q, k, v = (t.to(dtype).contiguous() for t in (q, k, v))
            out, lse = flash_fwd(q, k, v, kv_mask, causal)
            torch.cuda.synchronize()
            ref, ref_lse = flash_fwd_plain(q, k, v, kv_mask, causal)
            tag = f"flash_fwd {str(dtype)[6:]} {name}"
            errs[(dtype, name)] = check_close(tag, out, ref, dtype)
            rows = ref_lse > -1e29
            check_close(tag + " lse", lse[rows], ref_lse[rows], torch.float32)
            if kv_mask is not None and not causal:
                if not bool((out[1] == 0).all()):
                    fail(f"{tag}: a fully masked row is not exact zeros")
    # timing at the prefill shape, bf16 causal (the serving path)
    q, k, v = (t.to(torch.bfloat16).contiguous()
               for t in flash_cases(device, gen)[0][1])
    nbytes, flops = flash_work(q, None, True)
    b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
    lib_err = max_err(sdpa(), flash_fwd_plain(q, k, v, None, True)[0])
    report["flash_fwd"] = dict(
        name="flash_fwd", route="cuda", source=FLASH_SOURCE,
        replaces=FLASH_TPU, tpu_kernel=FLASH_TPU,
        shape="B=1 H=12 S=1024 D=64 causal bf16",
        max_abs_err=errs[(torch.bfloat16, "causal")],
        max_abs_err_f32=errs[(torch.float32, "causal")],
        ms=timer.ms(lambda: flash_fwd(q, k, v, None, True)),
        plain_ms=timer.ms(lambda: flash_fwd_plain(q, k, v, None, True)),
        library_ms=timer.ms(sdpa), library="scaled_dot_product_attention",
        library_max_abs_err=lib_err,
        bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes, bound_flops=flops,
    )

    log("phase 3: paged_decode vs plain")
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, tables, positions = decode_case(device, gen, dtype)
        out = paged_flash_decode(q, kp, vp, tables, positions)
        torch.cuda.synchronize()
        ref = paged_flash_decode_plain(q, kp, vp, tables, positions)
        tag = f"paged_decode {str(dtype)[6:]}"
        errs[dtype] = check_close(tag, out, ref, dtype)
        if not bool((out[3] == 0).all()):
            fail(f"{tag}: the dead slot is not exact zeros")
        # the NULL page mid-table is skipped: garbage there changes nothing
        kp2 = kp.clone()
        kp2[0] = 1e4
        if not torch.equal(paged_flash_decode(q, kp2, vp, tables, positions), out):
            fail(f"{tag}: the NULL page mid-table was not skipped")
    nbytes, flops = decode_work(q, tables, positions, kp.shape[1])
    b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
    report["paged_decode"] = dict(
        name="paged_decode", route="cuda", source=DECODE_SOURCE,
        replaces=DECODE_TPU, tpu_kernel=DECODE_TPU,
        shape="8 slots x 12 heads x hd 64, 16-token pages, 64 pages/slot, bf16",
        max_abs_err=errs[torch.bfloat16], max_abs_err_f32=errs[torch.float32],
        ms=timer.ms(lambda: paged_flash_decode(q, kp, vp, tables, positions)),
        plain_ms=timer.ms(
            lambda: paged_flash_decode_plain(q, kp, vp, tables, positions)
        ),
        library_ms=None, library=None,
        bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes, bound_flops=flops,
    )
    return report


# ---------------------------------------------------------------------------
# phase 4: the serving slice
# ---------------------------------------------------------------------------
def prompts_for(seed, vocab):
    g = torch.Generator().manual_seed(seed)
    ps = [torch.randint(0, vocab, (n,), generator=g).tolist()
          for n in (16, 77, 180, 300)]
    # whole-page prefix (18 pages of 16 tokens) of the 300-token prompt
    hit = ps[3][:288] + torch.randint(0, vocab, (20,), generator=g).tolist()
    return ps, hit


def engine_config(dtype, fused):
    return {"inference": {
        "max_batch_slots": 8, "kv_block_size": 16, "fused_decode": fused,
        "dtype": dtype, "sampling": {"greedy": True},
    }}


def serve(model, dtype, fused, prompts, hit):
    import deepspeed_tpu_torch

    engine = deepspeed_tpu_torch.init_inference(
        model=model, config=engine_config(dtype, fused)
    )
    try:
        t0 = time.monotonic()
        out = engine.generate(prompts, max_new_tokens=32)
        out += engine.generate([hit], max_new_tokens=32)
        wall = time.monotonic() - t0
        m = engine.metrics
        stats = {
            "wall_s": wall,
            "cold_prefills": m.counter("infer/prefix_misses").value,
            "prefix_hits": m.counter("infer/prefix_hits").value,
            "decode_steps": m.histogram("infer/token_latency_ms").count,
            "decode_ms_sum": m.histogram("infer/token_latency_ms").sum,
            "tokens": m.counter("infer/tokens_generated").value,
            "requests": m.counter("infer/requests_completed").value,
            "ttft_ms_mean": m.histogram("infer/ttft_ms").sum
            / max(1, m.histogram("infer/ttft_ms").count),
            "prefill_ms_mean": m.histogram("infer/prefill_time_ms").sum
            / max(1, m.histogram("infer/prefill_time_ms").count),
        }
        return out, stats
    finally:
        engine.close()


def phase_profile(model, prompts):
    """Where the slice's time goes: torch.profiler over 4 concurrent
    requests (prefill + 15 decode steps) on a warm bf16 engine. Device
    time by kernel, and the device's idle share of the profiled wall time
    (the profiler's own host overhead inflates that wall time)."""
    import deepspeed_tpu_torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine = deepspeed_tpu_torch.init_inference(
        model=model, config=engine_config("bf16", True)
    )
    try:
        engine.generate([prompts[0]], max_new_tokens=2)
        torch.cuda.synchronize()
        with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
        ) as prof:
            t0 = time.monotonic()
            engine.generate(prompts, max_new_tokens=16)
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
    finally:
        engine.close()
    # device-side kernel events only (the host ops' rows repeat the time
    # of the kernels they launched)
    device = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda kv: -kv[1],
    )
    busy_ms = sum(ms for _, ms, _ in device)
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
        "top_device_ms": [
            {"name": name[:80], "ms": ms, "calls": n}
            for name, ms, n in device[:8]
        ],
    }


def phase_slice(seed, card):
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel
    from deepspeed_tpu_torch.ops.attention import flash_fwd
    from deepspeed_tpu_torch.ops.decode_attention import paged_flash_decode

    cfg = GPT2Config.small()
    model = GPT2LMHeadModel(cfg, device="cuda", seed=seed)
    prompts, hit = prompts_for(seed, cfg.vocab_size)

    log("phase 4: warm-up engine")
    serve(model, "bf16", True, [prompts[0]], prompts[0][:8])

    log("phase 4: GPT-2 small, bf16, paged KV, fused decode")
    flash_fwd.launches = 0
    paged_flash_decode.launches = 0
    out_bf16, st = serve(model, "bf16", True, prompts, hit)
    torch.cuda.synchronize()
    launches = {"flash_fwd": flash_fwd.launches,
                "paged_decode": paged_flash_decode.launches}
    log(f"  launches {launches} stats {json.dumps(st)}")
    if st["prefix_hits"] < 1:
        fail("the 5th prompt did not hit the prefix cache")
    if launches["flash_fwd"] < N_LAYER * st["cold_prefills"]:
        fail(f"flash_fwd launched {launches['flash_fwd']} times for "
             f"{st['cold_prefills']} cold prefills")
    if launches["paged_decode"] < N_LAYER * st["decode_steps"]:
        fail(f"paged_decode launched {launches['paged_decode']} times for "
             f"{st['decode_steps']} decode steps")
    if st["requests"] != 5 or any(len(o) != 32 for o in out_bf16):
        fail(f"expected 5 requests x 32 tokens, got {[len(o) for o in out_bf16]}")
    if not all(0 <= t < cfg.vocab_size for o in out_bf16 for t in o):
        fail("a generated token lies outside the vocabulary")
    decode_tokens = st["tokens"] - st["requests"]
    tok_s = decode_tokens / (st["decode_ms_sum"] / 1e3)
    log(f"  TTFT mean {st['ttft_ms_mean']:.3f} ms (prefill mean "
        f"{st['prefill_ms_mean']:.3f} ms), decode {tok_s:.1f} tokens/s "
        f"over {st['decode_steps']} steps on {card}")

    log("phase 4: float32, fused decode on and off")
    out_f, st_f = serve(model, "fp32", True, prompts, hit)
    out_u, _ = serve(model, "fp32", False, prompts, hit)
    reqs = prompts + [hit]
    for r, (a, b) in enumerate(zip(out_f, out_u)):
        if a != b:
            step = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            ids = torch.tensor([reqs[r] + b[:step]], device="cuda")
            top2 = torch.topk(model(ids)[0, -1, :cfg.vocab_size].float(), 2)
            gap = float(top2.values[0] - top2.values[1])
            fail(f"request {r}: fused and unfused greedy tokens differ at "
                 f"step {step} (top-2 logit gap {gap:.3e})")
    log(f"  fused == unfused for all {len(out_f)} requests")
    # the first token agrees with the model's full forward on the prompt
    ref = model(torch.tensor([prompts[0]], device="cuda"))
    want = int(ref[0, -1, :cfg.vocab_size].argmax())
    if out_f[0][0] != want:
        fail(f"first token {out_f[0][0]} != full-forward argmax {want}")
    if not bool(torch.isfinite(ref).all()):
        fail("full-forward logits are not finite")

    log("phase 4: profile")
    prof = phase_profile(model, prompts)
    log(json.dumps({"profile": prof}))
    return launches, {
        "ttft_ms_mean": st["ttft_ms_mean"],
        "prefill_ms_mean": st["prefill_ms_mean"],
        "decode_tokens_per_s": tok_s,
        "decode_steps": st["decode_steps"],
        "cold_prefills": st["cold_prefills"],
        "prefix_hits": st["prefix_hits"],
        "wall_s": st["wall_s"],
        "fp32_wall_s": st_f["wall_s"],
        "profile_device_idle_share": prof["device_idle_share"],
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    # phase 1: probe
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from deepspeed_tpu_torch.ops import kernel_lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # phase 2: build
    t0 = time.monotonic()
    built = kernel_lib.build()
    log(f"phase 2: built {sorted(built)} in {time.monotonic() - t0:.1f} s "
        "(one nvcc per source, in parallel)")
    for name, report in built.items():
        log(f"  {name}:")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")

    kernels = phase_kernels(device, args.seed)
    launches, slice_stats = phase_slice(args.seed, smi)
    for name, n in launches.items():
        kernels[name]["launches"] = n
        kernels[name]["kernel_ms"] = kernels[name]["ms"]
    kernels["flash_fwd"]["launches_per_cold_prefill"] = (
        launches["flash_fwd"] / slice_stats["cold_prefills"]
    )
    kernels["paged_decode"]["launches_per_decode_step"] = (
        launches["paged_decode"] / slice_stats["decode_steps"]
    )
    log(json.dumps({"slice": slice_stats, "card": smi}))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

"""Chip smoke test for the PyTorch/CUDA port (deepspeed_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. probe   — require CUDA; print the card's name and power limit.
  2. build   — compile every CUDA kernel of the three slices from csrc/
               (one nvcc per source, all started together) and print the
               seconds, ptxas's registers and spills per kernel, and the
               count of HGMMA (wgmma) and UTMALDG (TMA load) instructions
               in each kernel's SASS (cuobjdump -sass); fails unless every
               bfloat16/float16 instantiation of the tensor-core forward
               and dK/dV kernels holds both.
  3. kernels — each kernel against its plain PyTorch version on the same
               inputs, float32 and bfloat16, at the serving path's shapes
               (plus a key-mask case, a fully masked row, a dead slot and
               a NULL page mid-table), with the tolerances below; then
               each kernel's time beside its plain version's, one PyTorch
               library call's where there is one, and its bound. The
               forward and its SDPA yardstick are timed both ways (``ms``
               and ``device_ms``, see Timer).
     3b. training kernels — at GPT-2 small's training shape (B=8, H=12,
               S=1024, D=64, causal): the forward with dropout, dQ and
               dK/dV with and without a padding mask and dropout, in
               f32, bf16 and fp16, and LAMB phase 1 over GPT-2 small's
               real parameters (f32, bf16 and fp16 grads; FusedLamb's
               trust ratios against the plain Lamb's). Then their times,
               bounds and library yardsticks (SDPA forward and backward,
               timed only); the forward and dK/dV and their yardsticks
               both ways, at dropout 0.1 and at 0 (the hash's share).
     3c. sgmv  — the SGMV kernel against its plain version at GPT-2
               small's four LoRA target shapes, rank 16, B = 8, ids mixing
               the identity row 0, repeats and the highest row, float32
               and bfloat16 (identity rows exactly zero; in bfloat16 the
               output must lie ten times nearer the plain version, which
               rounds t, than the same arithmetic with t unrounded); then
               its time (as Timer gives it, and on the device alone), its
               plain version's and its bound at B = 8 and B = 64.
  4. serve   — init_inference on GPT-2 small (random weights from --seed,
               bf16, paged KV, fused decode): 4 mixed-length prompts and
               a 5th that hits the prefix cache, 32 new tokens each. Both
               kernels' launch counters must move on this run (flash >= 12
               per cold prefill, decode >= 12 per decode step). Then the
               same requests in float32 with fused decode on and off must
               give identical greedy tokens, and the float32 engine's first
               token must match the model's full forward on the prompt.
               Last, torch.profiler over a warm bf16 run: device time by
               kernel and the device's idle share.
  5. train   — deepspeed_tpu_torch.initialize() on GPT-2 small at full
               width and depth (seq 1024, bf16, dropout 0.1, micro-batch
               8, accumulation 2, clipping 1.0, WarmupLR): 8 train_batch
               windows of Adam on one fixed batch from --seed (the loss
               must be finite and fall, no step skipped, and flash_fwd,
               flash_bwd_dq and flash_bwd_dkv each launched exactly 12
               times per micro-step), then 3 windows of FusedLamb (6 LAMB
               launches per step, trust ratios finite and inside
               [min_coeff, max_coeff]), 3 windows of Adam in real float16
               with dynamic loss scaling (a skip allowed, a step taken),
               then one float32 micro-step at
               dropout 0 whose gradients through the kernels must match
               the gradients through the plain versions; step time,
               tokens/s, peak memory and a torch.profiler window.
  6. adapters — the multi-LoRA slice on GPT-2 small. Fine-tune:
               initialize() with adapters {rank 16} (seq 1024, bf16,
               dropout 0.1, Adam, 4 windows): the loss finite and falling,
               the base bitwise unchanged, exactly 2,359,296 trainable
               parameters, the attention kernels launched exactly 12 times
               per micro-step. Serve: init_inference with adapters {rank
               16, pool_slots 4} (bf16, paged KV, fused decode) loads the
               fine-tuned adapter and two synthetic ones from --seed and
               decodes one batch of 8 requests mixing the three and the
               base model: SGMV launched exactly 48 times per decode step
               (4 targets x 12 layers); the base requests equal an
               adapter-free engine's tokens; the batch equals solo runs
               (prefix cache off); float32 fused and unfused decode give
               identical greedy tokens; TTFT and decode tokens/s with and
               without the adapters block; SGMV's share of a profiled
               decode window.
  7. report  — a JSON line of per-kernel numbers, the nvidia-smi line,
               then the last line {"ok": true, "device": {...}}.

The attention kernels take two routes by dtype: bfloat16 and float16 the
tensor-core forward and dK/dV kernels (wgmma + TMA), float32 the FMA
kernels (the tensor cores take float32 only as TF32); dQ is the FMA
kernel at every dtype.

Tolerances: float32 kernel vs plain atol = rtol = 1e-4 (same float32
arithmetic in another summation order; observed errors sit near 1e-6);
bfloat16 atol = rtol = 1e-2 (both round p and the output to bfloat16, at
different points of the online softmax: one bf16 ulp of an output in
[1, 2) is 7.8e-3, and rtol 1e-2 covers one ulp at any magnitude);
float16 atol = rtol = 2e-3 (the same reasoning, at float16's 2**-10). The
backward kernels' gradients are held with atol = tol * max|plain| (the
tolerance relative to the tensor's own scale: dQ, dK and dV at this
shape are ~1e-2, where an absolute 1e-2 would pass anything). LAMB: the
moments and u to rtol 1e-5 (the kernel rounds as PyTorch does; u may
differ by an ulp), the block partials and trust ratios to rtol 1e-5
(float32 sums in another order). Whole-model float32 gradients, kernels
vs plain: max|diff| <= 1e-4 * max|plain| per parameter. SGMV: float32
atol = rtol = 1e-4; bfloat16 atol = 1e-2 x each output row's largest
magnitude (t is rounded to bfloat16 before the second product, and a
summation in another order can move it by one bf16 ulp, 2**-8 relative),
and its error against the plain version below a tenth of its error
against the unrounded-t arithmetic (which pins where t is rounded).
"""

import argparse
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {  # dense, H100 SXM at 700 W (NVIDIA data sheet)
    torch.bfloat16: 989e12,  # tensor cores
    torch.float32: 67e12,    # outside the tensor cores
}
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2, torch.float16: 2e-3}
LAMB_RTOL = 1e-5
N_LAYER = 12
TRAIN_SHAPE = (8, 12, 1024, 64)  # B, H, S, D: GPT-2 small, micro-batch 8
DROPOUT = 0.1
FLASH_SOURCE = "deepspeed_tpu_torch/csrc/flash_fwd.cu"
BWD_SOURCE = "deepspeed_tpu_torch/csrc/flash_bwd.cu"
LAMB_SOURCE = "deepspeed_tpu_torch/csrc/lamb_phase1.cu"
DECODE_SOURCE = "deepspeed_tpu_torch/csrc/paged_decode.cu"
SGMV_SOURCE = "deepspeed_tpu_torch/csrc/sgmv.cu"
FLASH_TPU = "deepspeed_tpu/ops/attention.py:140"
DQ_TPU = "deepspeed_tpu/ops/attention.py:210"
DKV_TPU = "deepspeed_tpu/ops/attention.py:262"
LAMB_TPU = "deepspeed_tpu/ops/pallas.py:67"
DECODE_TPU = "deepspeed_tpu/ops/decode_attention.py:66"
SGMV_TPU = "deepspeed_tpu/ops/decode_attention.py:206"
LORA_RANK = 16
LORA_POOL_SLOTS = 4
# GPT-2 small's LoRA targets: (in, out)
LORA_SHAPES = {"attn_qkvw": (768, 2304), "attn_ow": (768, 768),
               "inter_w": (768, 3072), "output_w": (3072, 768)}


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
    K/V cold). The stream is idle when the call starts, so the time
    includes the host's enqueue of the call (the Python wrapper, the
    launch). With ``spin=True`` a device spin of SPIN_CYCLES (~0.5 ms) is
    queued ahead of each call instead, the enqueue overlaps it, and the
    events time the device work alone."""

    SPIN_CYCLES = 1_000_000

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, iters=20, warmup=3, spin=False):
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            if spin:
                torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


# the kernels that must run on the tensor cores, by library: every
# bfloat16/float16 instantiation (2 dtypes x 2 head dims) holds wgmma
# (HGMMA) and TMA loads (UTMALDG)
TC_KERNELS = {"flash_fwd": "flash_fwd_kernel_tc",
              "flash_bwd": "flash_bwd_dkv_kernel_tc"}
# the FMA kernels' Timer readings at these shapes before the bf16/fp16
# route moved to the tensor cores (H100 80GB HBM3, 700 W; PERF.md), printed
# beside this run's readings, not part of the kernels line
FMA_BEFORE_MS = {"flash_fwd": 2.204, "flash_fwd serve": 0.3129,
                 "flash_bwd_dkv": 3.075}
ROUTE = {"flash_fwd": "wgmma+tma (bf16, fp16); FMA (float32)",
         "flash_bwd_dq": "FMA (every dtype)",
         "flash_bwd_dkv": "wgmma+tma (bf16, fp16); FMA (float32)"}


def cuobjdump_path():
    """The toolkit's cuobjdump beside nvcc, or the copy Triton carries."""
    from deepspeed_tpu_torch.ops import kernel_lib

    candidates = [Path(kernel_lib.nvcc_path()).with_name("cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        candidates.append(Path(spec.origin).parent / "backends" / "nvidia"
                          / "bin" / "cuobjdump")
    for path in candidates:
        if path.is_file():
            return str(path)
    fail(f"cuobjdump not found (looked at {[str(c) for c in candidates]})")


def sass_counts(name):
    """{kernel: [HGMMA, UTMALDG]} over the SASS of csrc/<name>.cu's library
    (mangled kernel names, as cuobjdump prints them)."""
    from deepspeed_tpu_torch.ops import kernel_lib

    sass = subprocess.run(
        [cuobjdump_path(), "-sass", str(kernel_lib.library_path(name))],
        capture_output=True, text=True, check=True,
    ).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            func = line.split("Function : ", 1)[1].strip()
            counts[func] = [0, 0]
        elif func is not None:
            counts[func][0] += "HGMMA" in line
            counts[func][1] += "UTMALDG" in line
    return counts


def phase_sass():
    """Print each kernel's HGMMA and UTMALDG counts; fail unless every
    tensor-core kernel instantiation holds both."""
    from deepspeed_tpu_torch.ops import kernel_lib

    log("phase 2: SASS instruction counts (HGMMA = wgmma, UTMALDG = TMA load)")
    out = {}
    for name in kernel_lib.SIGNATURES:
        counts = sass_counts(name)
        out[name] = counts
        for func, (hgmma, utmaldg) in counts.items():
            log(f"  {name}: {func}: HGMMA {hgmma} UTMALDG {utmaldg}")
    for name, fragment in TC_KERNELS.items():
        tc = {f: c for f, c in out[name].items() if fragment in f}
        if len(tc) != 4 or not all(h and u for h, u in tc.values()):
            fail(f"{name}: the tensor-core kernels {fragment} lack HGMMA or "
                 f"UTMALDG instructions: {tc}")
    return out


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, want, dtype, scaled=False):
    """``got`` against ``want`` at TOL[dtype]; with ``scaled`` the absolute
    tolerance is TOL times ``want``'s largest magnitude."""
    tol = TOL[dtype]
    atol = tol * float(want.float().abs().max()) if scaled else tol
    err = max_err(got, want)
    ok = torch.allclose(got.float(), want.float(), atol=atol, rtol=tol)
    log(f"  {name}: max_abs_err {err:.3e} (atol {atol:.3g}, rtol {tol:g}) "
        f"{'ok' if ok else 'MISMATCH'}")
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


def visible_pairs(q, kv_mask, causal):
    """The (query, key) pairs that attend, over every batch row and head
    (self-attention, Sq == Sk)."""
    b, h, s, _ = q.shape
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    vis = (j <= i) if causal else torch.ones(s, s, dtype=torch.bool, device=q.device)
    if kv_mask is not None:
        return int((vis[None] & (kv_mask[:, None, :] != 0)).sum()) * h
    return int(vis.sum()) * b * h


def flash_work(q, kv_mask, causal, which="fwd"):
    """Bytes and flops the function needs on these inputs, each input read
    once and each output written once. fwd: q, k, v in, out and lse out;
    4*D flops per visible pair (q k^T, p v). dq: q, k, v, dO, lse, delta
    in, dQ out; 6*D flops a pair (s, dp, dQ). dkv: the same inputs, dK and
    dV out; 8*D flops a pair (s, dp, dK, dV). The dropout hash is not
    counted."""
    b, h, s, d = q.shape
    tensor = b * h * s * d * q.element_size()
    rows = b * h * s * 4
    nbytes, per_pair = {
        "fwd": (4 * tensor + rows, 4 * d),
        "dq": (5 * tensor + 2 * rows, 6 * d),
        "dkv": (6 * tensor + 2 * rows, 8 * d),
    }[which]
    if kv_mask is not None:
        nbytes += kv_mask.numel() * 4
    return nbytes, per_pair * visible_pairs(q, kv_mask, causal)


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
    kernel = lambda: flash_fwd(q, k, v, None, True)
    lib_err = max_err(sdpa(), flash_fwd_plain(q, k, v, None, True)[0])
    report["flash_fwd"] = dict(
        name="flash_fwd", route="cuda", route_detail=ROUTE["flash_fwd"],
        source=FLASH_SOURCE, replaces=FLASH_TPU, tpu_kernel=FLASH_TPU,
        shape="B=1 H=12 S=1024 D=64 causal bf16",
        max_abs_err=errs[(torch.bfloat16, "causal")],
        max_abs_err_f32=errs[(torch.float32, "causal")],
        ms=timer.ms(kernel), device_ms=timer.ms(kernel, spin=True),
        plain_ms=timer.ms(lambda: flash_fwd_plain(q, k, v, None, True)),
        library_ms=timer.ms(sdpa),
        library_device_ms=timer.ms(sdpa, spin=True),
        library="scaled_dot_product_attention",
        library_max_abs_err=lib_err,
        bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes, bound_flops=flops,
    )
    log(f"  flash_fwd (serving shape): {json.dumps(report['flash_fwd'])}")
    log(f"  flash_fwd (serving shape): ms {report['flash_fwd']['ms']:.4f}, "
        f"device_ms {report['flash_fwd']['device_ms']:.4f}; before_ms "
        f"{FMA_BEFORE_MS['flash_fwd serve']} (the FMA kernel)")

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
# phase 3b: the training kernels vs plain
# ---------------------------------------------------------------------------
def train_mask(device):
    """A padding mask for the 8 training rows: full, ragged and one dead
    row (index 2)."""
    b, _, s, _ = TRAIN_SHAPE
    mask = torch.zeros(b, s, dtype=torch.int32, device=device)
    for row, n in enumerate((1024, 700, 0, 1000, 513, 1024, 64, 900)):
        mask[row, :n] = 1
    return mask


def check_flash_training(device, gen):
    """flash_fwd, flash_bwd_dq and flash_bwd_dkv against their plain
    versions at the training shape, causal, with and without the padding
    mask and dropout, float32 and bfloat16. The backward kernels take the
    plain forward's out and lse, so both versions see the same inputs.
    Returns the max errors by (kernel, dtype, case)."""
    from deepspeed_tpu_torch.ops import attention as A

    b, h, s, d = TRAIN_SHAPE
    mask = train_mask(device)
    base = [torch.randn(b, h, s, d, device=device, generator=gen)
            for _ in range(4)]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        q, k, v, dout = (t.to(dtype) for t in base)
        for kv_mask in (None, mask):
            for rate in (0.0, DROPOUT):
                case = (("mask" if kv_mask is not None else "causal")
                        + ("+dropout" if rate else ""))
                tag = f"{str(dtype)[6:]} {case}"
                args = (q, k, v, kv_mask, True, None, rate, 4321)
                out, lse = A.flash_fwd(*args)
                torch.cuda.synchronize()
                ref, ref_lse = A.flash_fwd_plain(*args)
                errs[("flash_fwd", dtype, case)] = check_close(
                    f"flash_fwd {tag}", out, ref, dtype)
                rows = ref_lse > -1e29
                check_close(f"flash_fwd {tag} lse", lse[rows], ref_lse[rows],
                            torch.float32)
                delta = (dout.float() * ref.float()).sum(dim=-1)
                bargs = (q, k, v, kv_mask, dout, ref_lse, delta, True, None,
                         rate, 4321)
                dq = A.flash_bwd_dq(*bargs)
                dk, dv = A.flash_bwd_dkv(*bargs)
                torch.cuda.synchronize()
                want = (A.flash_bwd_dq_plain(*bargs),
                        *A.flash_bwd_dkv_plain(*bargs))
                for name, got, ref_g in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                            want):
                    kernel = "flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"
                    err = check_close(f"{kernel} {name} {tag}", got, ref_g,
                                      dtype, scaled=True)
                    key = (kernel, dtype, case)
                    errs[key] = max(errs.get(key, 0.0), err)
                    if kv_mask is not None and not bool((got[2] == 0).all()):
                        fail(f"{kernel} {name} {tag}: the dead row's "
                             "gradient is not exact zeros")
                del out, lse, ref, ref_lse, delta, dq, dk, dv, want
    return errs


def check_lamb(device, gen, seed):
    """LAMB phase 1 over GPT-2 small's parameters (all 148 tensors in one
    launch) against its plain version, float32 and bfloat16 grads; then
    one FusedLamb step (6 launches) against the plain Lamb on the same
    state. Returns (max relative partial error, max relative trust-ratio
    error, the timing operands)."""
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel
    from deepspeed_tpu_torch.ops.fused_lamb import (
        FusedLamb, lamb_phase1, lamb_phase1_plain,
    )
    from deepspeed_tpu_torch.ops.optimizers import (
        Lamb, bias_corrections, param_groups,
    )

    model = GPT2LMHeadModel(GPT2Config.small(), device=device, seed=seed)
    params = {n: p.detach() for n, p in model.named_parameters()}
    names = [n for grp in param_groups(params).values() for n in grp]
    ps = [params[n] for n in names]

    def noise(scale):
        return [torch.randn(p.shape, device=device, generator=gen) * scale
                for p in ps]

    g32, m0 = noise(1e-3), noise(1e-4)
    v0 = [x * x for x in noise(1e-3)]
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
              eps_inside_sqrt=False)
    c1, c2 = bias_corrections(0.9, 0.999, 3)

    def rel(got, want):
        return float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())

    worst_partial = 0.0
    for gdtype in (torch.float32, torch.bfloat16, torch.float16):
        gs = [g.to(gdtype) for g in g32]
        runs = []
        for fn in (lamb_phase1, lamb_phase1_plain):
            ms, vs = [m.clone() for m in m0], [v.clone() for v in v0]
            us = [torch.empty_like(p) for p in ps]
            wsq, usq = fn(ps, gs, ms, vs, us, c1, c2, 0.5, **kw)
            torch.cuda.synchronize()
            runs.append((wsq, usq, ms, vs, us))
        tag = f"lamb_phase1 {str(gdtype)[6:]} grads"
        for what, i in (("m", 2), ("v", 3), ("u", 4)):
            for got, want in zip(runs[0][i], runs[1][i]):
                scale = float(want.abs().max())
                if not torch.allclose(got, want, rtol=LAMB_RTOL,
                                      atol=LAMB_RTOL * scale):
                    fail(f"{tag}: {what} disagrees with the plain version "
                         f"(max abs err {max_err(got, want):.3e})")
        for what, i in (("sum p^2", 0), ("sum u^2", 1)):
            err = rel(runs[0][i], runs[1][i])
            worst_partial = max(worst_partial, err)
            log(f"  {tag} block partials {what}: max rel err {err:.3e} "
                f"(tol {LAMB_RTOL:g}) {'ok' if err <= LAMB_RTOL else 'MISMATCH'}")
            if err > LAMB_RTOL:
                fail(f"{tag}: the block partials disagree")

    # one FusedLamb step (the kernel) against the plain Lamb
    grads = dict(zip(names, g32))
    steps = []
    for opt in (FusedLamb(weight_decay=0.01), Lamb(weight_decay=0.01)):
        ps_ = {n: p.clone() for n, p in params.items()}
        state = opt.init(ps_)
        for n, m, v in zip(names, m0, v0):
            state["mu"][n].copy_(m)
            state["nu"][n].copy_(v)
        before = lamb_phase1.launches
        aux = opt.apply(ps_, grads, state, 1e-3, grad_scale=0.5)
        torch.cuda.synchronize()
        steps.append((torch.stack(aux["lamb_coeffs"]), ps_,
                      lamb_phase1.launches - before))
    (fused, p_fused, n_fused), (plain, p_plain, _) = steps
    if n_fused != 6:
        fail(f"FusedLamb launched lamb_phase1 {n_fused} times for GPT-2 "
             "small, expected 6 (5 large groups + 1 packed launch)")
    ratio_err = rel(fused, plain)
    log(f"  FusedLamb vs Lamb trust ratios ({len(fused)} groups): max rel "
        f"err {ratio_err:.3e} (tol {LAMB_RTOL:g})")
    if ratio_err > LAMB_RTOL:
        fail("FusedLamb's trust ratios disagree with the plain Lamb's")
    for n in names:
        scale = float(p_plain[n].abs().max())
        if not torch.allclose(p_fused[n], p_plain[n], rtol=LAMB_RTOL,
                              atol=LAMB_RTOL * scale):
            fail(f"FusedLamb's update of {n} disagrees with the plain Lamb's")
    return worst_partial, ratio_err, (ps, g32, m0, v0, c1, c2, kw)


def phase_train_kernels(device, seed, report):
    """Phase 3b; adds the training kernels' entries to ``report`` and
    moves the serving shape's flash_fwd numbers under ``serve``."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import attention as A
    from deepspeed_tpu_torch.ops.fused_lamb import (
        lamb_phase1, lamb_phase1_plain,
    )

    gen = torch.Generator(device=device).manual_seed(seed + 1)
    timer = Timer(device)
    log("phase 3b: flash forward (dropout) and backward vs plain")
    errs = check_flash_training(device, gen)
    log("phase 3b: lamb_phase1 vs plain")
    lamb_err, ratio_err, lamb_ops = check_lamb(device, gen, seed)

    log("phase 3b: timing at the training shape (bf16, causal, dropout 0.1 "
        "and 0)")
    b, h, s, d = TRAIN_SHAPE
    q, k, v, dout = (torch.randn(b, h, s, d, device=device, generator=gen)
                     .to(torch.bfloat16) for _ in range(4))
    out, lse = A.flash_fwd(q, k, v, None, True, None, DROPOUT, 7)
    delta = (dout.float() * out.float()).sum(dim=-1)

    def args(name, rate):
        if name == "flash_fwd":
            return (q, k, v, None, True, None, rate, 7)
        return (q, k, v, None, dout, lse, delta, True, None, rate, 7)

    def sdpa_calls(rate):
        """SDPA forward and backward (dQ, dK and dV together) at ``rate``:
        the yardsticks, timed only."""
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                                  dropout_p=rate)
        fwd = lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=rate)
        bwd = lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), dout,
                                          retain_graph=True)
        return fwd, bwd

    def both(fn):
        """``fn``'s time as Timer gives it and on the device alone."""
        return timer.ms(fn), timer.ms(fn, spin=True)

    sdpa = {rate: [both(fn) for fn in sdpa_calls(rate)]
            for rate in (DROPOUT, 0.0)}
    shape = "B=8 H=12 S=1024 D=64 causal dropout 0.1 bf16"
    bf, f32 = torch.bfloat16, torch.float32
    bwd_lib = ("scaled_dot_product_attention backward (dQ, dK and dV "
               "together), dropout 0.1")
    entries = {
        "flash_fwd": (FLASH_SOURCE, FLASH_TPU, "fwd", A.flash_fwd,
                      A.flash_fwd_plain, 0,
                      "scaled_dot_product_attention forward, dropout 0.1"),
        "flash_bwd_dq": (BWD_SOURCE, DQ_TPU, "dq", A.flash_bwd_dq,
                         A.flash_bwd_dq_plain, 1, bwd_lib),
        "flash_bwd_dkv": (BWD_SOURCE, DKV_TPU, "dkv", A.flash_bwd_dkv,
                          A.flash_bwd_dkv_plain, 1, bwd_lib),
    }
    serve = report.pop("flash_fwd")
    cases = ("causal", "mask", "causal+dropout", "mask+dropout")
    for name, (src, tpu, which, fn, plain, lib_i, lib) in entries.items():
        nbytes, flops = flash_work(q, None, True, which)
        b_ms, b_by = bound(nbytes, flops, bf)
        fargs = args(name, DROPOUT)
        ms, device_ms = both(lambda: fn(*fargs))
        lib_ms, lib_device_ms = sdpa[DROPOUT][lib_i]
        report[name] = dict(
            name=name, route="cuda", route_detail=ROUTE[name], source=src,
            replaces=tpu, tpu_kernel=tpu, shape=shape,
            max_abs_err=max(errs[(name, bf, c)] for c in cases),
            max_abs_err_f32=max(errs[(name, f32, c)] for c in cases),
            max_abs_err_f16=max(errs[(name, torch.float16, c)]
                                for c in cases),
            ms=ms, device_ms=device_ms,
            plain_ms=timer.ms(lambda: plain(*fargs), iters=5, warmup=1),
            library_ms=lib_ms, library_device_ms=lib_device_ms, library=lib,
            bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
            bound_flops=flops,
        )
        if name != "flash_bwd_dq":  # the redesigned kernels at dropout 0
            zargs = args(name, 0.0)
            ms0, device_ms0 = both(lambda: fn(*zargs))
            lib_ms0, lib_device_ms0 = sdpa[0.0][lib_i]
            report[name].update(
                ms_dropout0=ms0, device_ms_dropout0=device_ms0,
                library_ms_dropout0=lib_ms0,
                library_device_ms_dropout0=lib_device_ms0)
        log(f"  {name}: {json.dumps(report[name])}")
        if name in FMA_BEFORE_MS:
            log(f"  {name}: ms {ms:.4f}, device_ms {device_ms:.4f}; "
                f"before_ms {FMA_BEFORE_MS[name]} (the FMA kernel)")
    report["flash_fwd"]["serve"] = {
        key: serve[key] for key in ("shape", "max_abs_err", "max_abs_err_f32",
                                    "ms", "device_ms", "plain_ms",
                                    "library_ms", "library_device_ms",
                                    "bound_ms", "bound_by")
    }

    # LAMB phase 1 over every GPT-2 small parameter in one launch (the
    # step's 6 launches together), float32 grads
    ps, g32, m0, v0, c1, c2, kw = lamb_ops
    ms, vs = [m.clone() for m in m0], [v.clone() for v in v0]
    us = [torch.empty_like(p) for p in ps]
    largs = (ps, g32, ms, vs, us, c1, c2, 0.5)
    n = sum(p.numel() for p in ps)
    nblocks = sum(max(1, -(-p.numel() // 4096)) for p in ps)
    # p, g, m, v read; m, v, u written (4 bytes each); two partials a block
    nbytes = n * 7 * 4 + nblocks * 8
    b_ms, b_by = bound(nbytes, 16 * n, f32)
    report["lamb_phase1"] = dict(
        name="lamb_phase1", route="cuda", source=LAMB_SOURCE,
        replaces=LAMB_TPU, tpu_kernel=LAMB_TPU,
        shape=f"GPT-2 small's {len(ps)} tensors ({n} float32 elements) in "
              "one launch, float32 grads",
        max_abs_err=lamb_err, max_abs_err_kind="max relative error of the "
        "block partials", trust_ratio_max_rel_err=ratio_err,
        ms=timer.ms(lambda: lamb_phase1(*largs, **kw)),
        plain_ms=timer.ms(lambda: lamb_phase1_plain(*largs, **kw), iters=5,
                          warmup=1),
        library_ms=None, library=None,
        bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes, bound_flops=16 * n,
    )
    return report


# ---------------------------------------------------------------------------
# phase 3c: the SGMV kernel vs plain
# ---------------------------------------------------------------------------
def sgmv_case(device, gen, dtype, din, dout, b):
    """An adapter pool as the engine holds it (rank 16, pool_slots 4: rows
    0..4, row 0 the zero identity), one layer's slice, and ``b`` slots
    whose ids mix the identity, repeats and the highest row."""
    rows = LORA_POOL_SLOTS + 1
    a_pool = torch.randn(rows, din, LORA_RANK, device=device,
                         generator=gen) * 0.02
    b_pool = torch.randn(rows, LORA_RANK, dout, device=device,
                         generator=gen) * 0.1
    a_pool[0] = 0
    b_pool[0] = 0
    x = torch.randn(b, din, device=device, generator=gen)
    pattern = [0, LORA_POOL_SLOTS, 2, 2, 1, 0, LORA_POOL_SLOTS, 3]
    ids = torch.tensor([pattern[i % len(pattern)] for i in range(b)],
                       dtype=torch.int32, device=device)
    return (x.to(dtype), a_pool.to(dtype).contiguous(),
            b_pool.to(dtype).contiguous(), ids)


def sgmv_work(x, a_pool, b_pool, ids):
    """Bytes and flops the function needs on these inputs: the DISTINCT
    non-identity adapter rows of A and B read once (id 0 reads nothing),
    x and ids read, the float32 output written; 2 * (in * r + r * out)
    flops a non-identity slot."""
    b, din = x.shape
    rank, dout = b_pool.shape[1], b_pool.shape[2]
    id_list = ids.tolist()
    distinct = len({i for i in id_list if i != 0})
    live = sum(1 for i in id_list if i != 0)
    es = x.element_size()
    nbytes = (distinct * (din * rank + rank * dout) * es + b * din * es
              + b * 4 + b * dout * 4)
    return nbytes, 2 * live * (din * rank + rank * dout)


def sgmv_unrounded(x, a_pool, b_pool, ids):
    """lora_sgmv_plain's arithmetic with t left in float32: what a kernel
    that skipped the rounding of t to the pool's dtype would give."""
    rows = ids.long()
    t = torch.einsum("bi,bir->br", x.float(), a_pool[rows].float())
    return torch.einsum("br,bro->bo", t, b_pool[rows].float())


def check_t_rounding(tag, out, ref, scale, unrounded):
    """The kernel rounds t where the plain version does: its output lies
    at least ten times nearer the rounded reference than the unrounded
    one (errors relative to each output row's scale)."""
    err_r = float(((out - ref) / scale).abs().max())
    err_u = float(((out - unrounded) / scale).abs().max())
    ok = err_r < 0.1 * err_u
    log(f"  {tag}: rounding of t: err vs rounded {err_r:.3e}, vs unrounded "
        f"{err_u:.3e} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{tag}: the kernel does not round t as its plain version does")


def phase_sgmv_kernels(device, seed, report):
    """Phase 3c; adds the SGMV entry to ``report``."""
    from deepspeed_tpu_torch.ops.decode_attention import (
        lora_sgmv,
        lora_sgmv_plain,
    )

    gen = torch.Generator(device=device).manual_seed(seed + 2)
    timer = Timer(device)
    log("phase 3c: sgmv vs plain (GPT-2 small's LoRA targets, rank 16, B=8)")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for target, (din, dout) in LORA_SHAPES.items():
            x, a_pool, b_pool, ids = sgmv_case(device, gen, dtype, din, dout,
                                               8)
            out = lora_sgmv(x, a_pool, b_pool, ids)
            torch.cuda.synchronize()
            ref = lora_sgmv_plain(x, a_pool, b_pool, ids)
            tag = f"sgmv {str(dtype)[6:]} {target} ({din}->{dout})"
            if out.dtype != torch.float32 or tuple(out.shape) != (8, dout):
                fail(f"{tag}: output {out.dtype} {tuple(out.shape)}")
            zero = (ids == 0).nonzero().flatten().tolist()
            if not zero or not all(bool((out[i] == 0).all()) for i in zero):
                fail(f"{tag}: an identity row is not exact zeros")
            if dtype == torch.float32:
                errs[(dtype, target)] = check_close(tag, out, ref, dtype)
            else:
                # relative to each output row's own scale
                scale = ref.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
                errs[(dtype, target)] = max_err(out, ref)
                check_close(tag + " / row scale", out / scale, ref / scale,
                            dtype)
                check_t_rounding(tag, out, ref, scale,
                                 sgmv_unrounded(x, a_pool, b_pool, ids))
    log("phase 3c: sgmv timing (bf16), B = 8 and B = 64")
    shapes = {}
    for b in (8, 64):
        for target, (din, dout) in LORA_SHAPES.items():
            x, a_pool, b_pool, ids = sgmv_case(device, gen, torch.bfloat16,
                                               din, dout, b)
            nbytes, flops = sgmv_work(x, a_pool, b_pool, ids)
            b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
            shapes[f"{target} B={b}"] = dict(
                ms=timer.ms(lambda: lora_sgmv(x, a_pool, b_pool, ids)),
                plain_ms=timer.ms(
                    lambda: lora_sgmv_plain(x, a_pool, b_pool, ids)
                ),
                device_ms=timer.ms(lambda: lora_sgmv(x, a_pool, b_pool, ids),
                                   spin=True),
                bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
                bound_flops=flops,
            )
            log(f"  {target} B={b}: {json.dumps(shapes[f'{target} B={b}'])}")
    host = sgmv_host_costs(device, gen)
    log(f"  host time per call: {json.dumps(host)}")
    head = shapes["inter_w B=8"]  # the widest target at the serving batch
    report["sgmv"] = dict(
        name="sgmv", route="cuda", source=SGMV_SOURCE, replaces=SGMV_TPU,
        tpu_kernel=SGMV_TPU,
        shape="inter_w 768->3072, rank 16, B=8, pool rows 5, bf16",
        max_abs_err=max(errs[(torch.bfloat16, t)] for t in LORA_SHAPES),
        max_abs_err_f32=max(errs[(torch.float32, t)] for t in LORA_SHAPES),
        ms=head["ms"], plain_ms=head["plain_ms"],
        library_ms=None, library=None,
        bound_ms=head["bound_ms"], bound_by=head["bound_by"],
        bound_bytes=head["bound_bytes"], bound_flops=head["bound_flops"],
        by_shape=shapes,
        device_ms=head["device_ms"], device_ms_kind="CUDA events around "
        "one call queued behind a device spin: the kernel alone, without "
        "the host wrapper and launch that ms includes",
        host_us_per_call=host,
    )
    return report


def sgmv_host_costs(device, gen, calls=200):
    """Host wall time per call, in microseconds, of the SGMV wrapper, of
    apply_lora's fused decode path around it (B=8) and of its gathered
    path at the prefill shape (1 x 1024 tokens), each called ``calls``
    times back to back with one synchronize at the end (the device keeps
    up, so the host's call rate is what is measured)."""
    from deepspeed_tpu_torch.ops.decode_attention import lora_sgmv
    from deepspeed_tpu_torch.ops.transformer import apply_lora

    din, dout = LORA_SHAPES["inter_w"]
    x, a_pool, b_pool, ids = sgmv_case(device, gen, torch.bfloat16, din,
                                       dout, 8)
    lora = ({"inter_w": (a_pool, b_pool)}, ids, 1.0, True)
    x3 = x[:, None, :]
    y3 = torch.zeros(8, 1, dout, dtype=torch.bfloat16, device=device)
    xp = torch.randn(1, 1024, din, device=device,
                     generator=gen).to(torch.bfloat16)
    yp = torch.zeros(1, 1024, dout, dtype=torch.bfloat16, device=device)
    lora_p = ({"inter_w": (a_pool, b_pool)}, ids[1:2], 1.0, True)
    cases = {
        "lora_sgmv": lambda: lora_sgmv(x, a_pool, b_pool, ids),
        "apply_lora_fused_decode": lambda: apply_lora(
            None, None, lora, "inter_w", x3, y3),
        "apply_lora_gathered_prefill": lambda: apply_lora(
            None, None, lora_p, "inter_w", xp, yp),
    }
    out = {}
    for name, fn in cases.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        out[name] = (t1 - t0) / calls * 1e6
    return out


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
        return out, engine_stats(engine, time.monotonic() - t0)
    finally:
        engine.close()


def engine_stats(engine, wall):
    """What a serving run counted: prefills, prefix hits, decode steps and
    their summed wall time, tokens, requests, mean TTFT and prefill."""
    m = engine.metrics
    return {
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


def phase_profile(model, prompts):
    """Where the slice's time goes: torch.profiler over 4 concurrent
    requests (prefill + 15 decode steps) on a warm bf16 engine. Device
    time by kernel, and the device's idle share of the profiled wall time
    (the profiler's own host overhead inflates that wall time)."""
    import deepspeed_tpu_torch
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
    return device_breakdown(prof, wall_ms)


# kernel-name fragments of the port's own kernels and of cuBLAS's GEMMs
OWN_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
               "flash_bwd_dkv_kernel", "paged_decode_kernel",
               "lamb_phase1_kernel", "sgmv_kernel")
GEMM_KERNELS = ("gemm", "nvjet", "cutlass", "xmma")


def device_breakdown(prof, wall_ms):
    """Device time by kernel in a torch.profiler window, the same summed
    over the port's kernels, cuBLAS's GEMMs and everything else, and the
    device's idle share of the window's wall time (the profiler's own
    host overhead inflates that wall time)."""
    from torch.autograd import DeviceType

    # device-side kernel events only (the host ops' rows repeat the time
    # of the kernels they launched)
    device = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda kv: -kv[1],
    )
    busy_ms = sum(ms for _, ms, _ in device)
    by_class = {"port_kernels": 0.0, "gemm": 0.0, "other": 0.0}
    own = {k: 0.0 for k in OWN_KERNELS}
    own_calls = {k: 0 for k in OWN_KERNELS}
    for name, ms, n in device:
        if any(k in name for k in OWN_KERNELS):
            by_class["port_kernels"] += ms
            kernel = next(k for k in OWN_KERNELS if k in name)
            own[kernel] += ms
            own_calls[kernel] += n
        elif any(k in name.lower() for k in GEMM_KERNELS):
            by_class["gemm"] += ms
        else:
            by_class["other"] += ms
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
        "device_ms_by_class": by_class,
        "device_ms_by_own_kernel": own,
        "calls_by_own_kernel": own_calls,
        "top_device_ms": [
            {"name": name[:80], "ms": ms, "calls": n}
            for name, ms, n in device[:8]
        ],
    }


def phase_slice(seed, card):
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    cfg = GPT2Config.small()
    model = GPT2LMHeadModel(cfg, device="cuda", seed=seed)
    prompts, hit = prompts_for(seed, cfg.vocab_size)

    log("phase 4: warm-up engine")
    serve(model, "bf16", True, [prompts[0]], prompts[0][:8])

    log("phase 4: GPT-2 small, bf16, paged KV, fused decode")
    zero_launches()
    out_bf16, st = serve(model, "bf16", True, prompts, hit)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"  launches {launches} stats {json.dumps(st)}")
    if launches["sgmv"] or launches["flash_bwd_dq"] or launches["lamb_phase1"]:
        fail(f"the adapter-free serving run launched {launches}")
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


# ---------------------------------------------------------------------------
# phase 5: the training slice
# ---------------------------------------------------------------------------
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def launch_counters():
    from deepspeed_tpu_torch.ops import attention as A
    from deepspeed_tpu_torch.ops.decode_attention import (
        lora_sgmv,
        paged_flash_decode,
    )
    from deepspeed_tpu_torch.ops.fused_lamb import lamb_phase1

    return {"flash_fwd": A.flash_fwd, "flash_bwd_dq": A.flash_bwd_dq,
            "flash_bwd_dkv": A.flash_bwd_dkv, "lamb_phase1": lamb_phase1,
            "paged_decode": paged_flash_decode, "sgmv": lora_sgmv}


def zero_launches():
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in launch_counters().items()}


def train_config(optimizer, lr, precision):
    """GPT-2 small's training config: 16 sequences a step as 2 micro-batches
    of 8, ``precision`` (the bf16 or fp16 block), clipping 1.0, WarmupLR to
    ``lr`` over 4 steps."""
    return {
        "train_batch_size": 16,
        "train_micro_batch_size_per_gpu": 8,
        "gradient_accumulation_steps": 2,
        **precision,
        "gradient_clipping": 1.0,
        "optimizer": {"type": optimizer, "params": {"lr": lr}},
        "scheduler": {"type": "WarmupLR", "params": {
            "warmup_min_lr": 0.0, "warmup_max_lr": lr,
            "warmup_num_steps": 4}},
        "steps_per_print": 1000,
    }


def train_batches(seed, vocab):
    """One fixed batch of 16 x 1024 token ids from ``seed``, as the two
    micro-batches (input_ids, labels) of a window; the labels are the ids
    (the model shifts them)."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, vocab, (16, 1024), generator=g).cuda()
    return [(ids[:8], ids[:8]), (ids[8:], ids[8:])]


def run_windows(engine, micro, n):
    """``n`` train_batch windows; their mean losses and wall seconds."""
    losses, secs = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        loss = float(engine.train_batch(iter(micro)))
        torch.cuda.synchronize()
        secs.append(time.monotonic() - t0)
        losses.append(loss)
    return losses, secs


def check_launches(path, got, micro_steps, lamb_steps=0):
    want = {name: N_LAYER * micro_steps for name in TRAIN_KERNELS}
    want["lamb_phase1"] = 6 * lamb_steps
    want["paged_decode"] = want["sgmv"] = 0
    log(f"  launches {got} (want {want})")
    if got != want:
        fail(f"{path}: kernel launches {got} differ from {want}")


BF16 = {"bf16": {"enabled": True}}


def train_gpt2(seed, optimizer, lr, windows, precision=BF16):
    """initialize() on GPT-2 small and ``windows`` train_batch windows;
    returns the engine, the launches, the losses and the window times.
    Fails unless every loss is finite and, without a loss scale (bf16),
    no step was skipped; with one (fp16), unless at least one step was
    taken."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    cfg = GPT2Config.small(dropout=DROPOUT)
    micro = train_batches(seed, cfg.vocab_size)
    model = GPT2LMHeadModel(cfg, device="cuda", seed=seed)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=train_config(optimizer, lr, precision)
    )
    zero_launches()
    losses, secs = run_windows(engine, micro, windows)
    launches = read_launches()
    log(f"  losses {losses}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{optimizer}: a window's loss is not finite")
    skips_ok = engine.loss_scale_state.dynamic
    if (engine.global_steps + engine.skipped_steps != windows
            or engine.global_steps < 1
            or (engine.skipped_steps and not skips_ok)):
        fail(f"{optimizer}: {engine.skipped_steps} skipped steps, "
             f"{engine.global_steps} taken of {windows}")
    return engine, micro, launches, losses, secs


def grads_kernels_vs_plain(seed):
    """One float32 micro-step of GPT-2 small at dropout 0: the gradients
    through the kernels against the gradients through the plain versions
    of the three attention kernels on the card. Returns the launches of
    the kernel run and the worst max|diff| / max|plain| over the
    parameters."""
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel
    from deepspeed_tpu_torch.ops import attention as A

    model = GPT2LMHeadModel(GPT2Config.small(dropout=0.0), device="cuda",
                            seed=seed)
    ids = train_batches(seed, model.config.vocab_size)[0][0]
    params = list(model.parameters())

    def grads():
        loss = model(ids, ids, train=True)
        return torch.autograd.grad(loss, params), float(loss.detach())

    zero_launches()
    (got, loss_k) = grads()
    torch.cuda.synchronize()
    launches = read_launches()
    kernels = (A.flash_fwd, A.flash_bwd_dq, A.flash_bwd_dkv)
    A.flash_fwd, A.flash_bwd_dq, A.flash_bwd_dkv = (
        A.flash_fwd_plain, A.flash_bwd_dq_plain, A.flash_bwd_dkv_plain)
    try:
        (want, loss_p) = grads()
    finally:
        A.flash_fwd, A.flash_bwd_dq, A.flash_bwd_dkv = kernels
    worst = max(float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
                for g, w in zip(got, want))
    log(f"  loss kernels {loss_k} plain {loss_p}; gradients max|diff| / "
        f"max|plain| {worst:.3e} (tol {TOL[torch.float32]:g})")
    if worst > TOL[torch.float32]:
        fail("float32 gradients through the kernels disagree with the "
             "plain versions'")
    return launches, worst


def phase_train(seed, card):
    from torch.profiler import ProfilerActivity, profile

    log("phase 5: GPT-2 small, Adam, bf16, dropout 0.1, 8 windows")
    torch.cuda.reset_peak_memory_stats()
    engine, micro, adam, losses, secs = train_gpt2(seed, "Adam", 1e-4, 8)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check_launches("Adam", adam, engine.micro_steps)
    if not losses[-1] < losses[0]:
        fail(f"Adam: the loss did not fall ({losses[0]} -> {losses[-1]})")
    warm = sorted(secs[1:])
    step_s = warm[len(warm) // 2]
    tok_s = 16 * 1024 / step_s
    log(f"  step (window of 2 micro-batches of 8 x 1024) median "
        f"{step_s * 1e3:.3f} ms over {len(warm)} warm windows, {tok_s:.1f} "
        f"tokens/s, peak memory {peak_gb:.3f} GiB on {card}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine.train_batch(iter(micro))
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    train_prof = device_breakdown(prof, wall_ms)
    log(json.dumps({"train_profile": train_prof}))
    del engine, micro, prof
    torch.cuda.empty_cache()

    log("phase 5: GPT-2 small, FusedLamb, 3 windows")
    engine, _, lamb, lamb_losses, _ = train_gpt2(seed, "FusedLamb", 1e-3, 3)
    check_launches("FusedLamb", lamb, engine.micro_steps, engine.global_steps)
    opt = engine.optimizer_obj
    coeffs = engine.lamb_coeffs
    log(f"  lamb_coeffs {coeffs.tolist()}")
    if (len(coeffs) != 16 or not bool(torch.isfinite(coeffs).all())
            or float(coeffs.min()) < opt.min_coeff
            or float(coeffs.max()) > opt.max_coeff):
        fail(f"FusedLamb: lamb_coeffs outside [{opt.min_coeff}, "
             f"{opt.max_coeff}] or not one per group")
    del engine
    torch.cuda.empty_cache()

    log("phase 5: GPT-2 small, Adam, real float16, loss scale from 2**16")
    fp16 = {"fp16": {"enabled": True, "initial_scale_power": 16}}
    engine, _, half, half_losses, _ = train_gpt2(seed, "Adam", 1e-4, 3, fp16)
    check_launches("fp16", half, engine.micro_steps)
    half_scale = engine.loss_scale_state.loss_scale
    half_skipped = engine.skipped_steps
    log(f"  loss scale {half_scale}, {half_skipped} skipped")
    del engine
    torch.cuda.empty_cache()

    log("phase 5: one float32 micro-step, kernels vs plain")
    f32_launches, grad_err = grads_kernels_vs_plain(seed)
    check_launches("float32 micro-step", f32_launches, 1)

    launches = {name: {"train_adam": adam[name], "train_fusedlamb": lamb[name],
                       "train_fp16": half[name]}
                for name in launch_counters()}
    return launches, {
        "adam_losses": losses,
        "adam_window_s": secs,
        "step_ms": step_s * 1e3,
        "tokens_per_s": tok_s,
        "peak_memory_gib": peak_gb,
        "fusedlamb_losses": lamb_losses,
        "fp16_losses": half_losses,
        "fp16_loss_scale": half_scale,
        "fp16_skipped_steps": half_skipped,
        "lamb_coeffs": coeffs.tolist(),
        "f32_grad_max_rel_err": grad_err,
        "profile_device_idle_share": train_prof["device_idle_share"],
        "profile_device_ms_by_class": train_prof["device_ms_by_class"],
    }


# ---------------------------------------------------------------------------
# phase 6: the multi-LoRA slice (LoRA fine-tune, adapter serving)
# ---------------------------------------------------------------------------
ADAPTER_PARAMS = 2_359_296  # 12 layers x 16 x (768+2304 + 768+768 + 768+3072 + 3072+768)


def lora_finetune(seed):
    """initialize() with the adapters block on GPT-2 small, 4 windows of
    Adam. Returns the (armed) model, its base state, the tuned adapter
    state, the launches and the stats."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel
    from deepspeed_tpu_torch.adapters import is_lora_name

    cfg = GPT2Config.small(dropout=DROPOUT)
    micro = train_batches(seed + 1, cfg.vocab_size)
    model = GPT2LMHeadModel(cfg, device="cuda", seed=seed)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    config = {
        "train_batch_size": 16, "train_micro_batch_size_per_gpu": 8,
        "gradient_accumulation_steps": 2, **BF16, "gradient_clipping": 1.0,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "adapters": {"enabled": True, "rank": LORA_RANK},
        "steps_per_print": 1000,
    }
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=config
    )
    n_train = sum(p.numel() for p in engine.params.values())
    log(f"  trainable parameters {n_train} (want {ADAPTER_PARAMS}), "
        f"{len(engine.frozen_base_params)} base tensors frozen")
    if n_train != ADAPTER_PARAMS or not all(
        is_lora_name(n) for n in engine.params
    ):
        fail("LoRA fine-tune: the trainable set is not the adapter")
    zero_launches()
    losses, secs = run_windows(engine, micro, 4)
    launches = read_launches()
    check_launches("LoRA fine-tune", launches, engine.micro_steps)
    log(f"  losses {losses}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"LoRA fine-tune: the loss is not finite and falling {losses}")
    if engine.global_steps != 4 or engine.skipped_steps:
        fail(f"LoRA fine-tune: {engine.global_steps} steps taken, "
             f"{engine.skipped_steps} skipped of 4")
    for n, p in model.named_parameters():
        if is_lora_name(n):
            continue
        if not torch.equal(p, before[n]) or not torch.equal(
            engine.frozen_base_params[n], before[n].to(torch.bfloat16)
        ):
            fail(f"LoRA fine-tune: base tensor {n} changed")
    log(f"  base bitwise unchanged ({len(before)} tensors)")
    adapter = engine.adapter_state_dict()
    if not any(t.any() for n, t in adapter.items() if n.endswith("_lora_b")):
        fail("LoRA fine-tune: the B factors did not move")
    warm = sorted(secs[1:])
    stats = {"losses": losses, "window_s": secs,
             "step_ms": warm[len(warm) // 2] * 1e3,
             "trainable_params": n_train}
    del engine
    torch.cuda.empty_cache()
    return model, before, adapter, launches, stats


def synthetic_adapter(base, seed):
    """A nonzero adapter from ``seed``: init_lora_params' A ~ N(0, 0.02),
    and B ~ N(0, 0.1) in place of its zeros."""
    from deepspeed_tpu_torch.adapters import init_lora_params

    g = torch.Generator().manual_seed(seed)
    state = init_lora_params(base, LORA_RANK, generator=g)
    for name, t in state.items():
        if name.endswith("_lora_b"):
            t.copy_(torch.randn(t.shape, generator=g) * 0.1)
    return state


def adapter_engine(model, base, dtype, fused, adapters, prefix_cache=True):
    """An engine serving ``base`` with the adapters block and ``adapters``
    ({name: state}) loaded, or adapter-free when ``adapters`` is None."""
    import deepspeed_tpu_torch

    config = engine_config(dtype, fused)
    if not prefix_cache:
        config["inference"]["prefix_cache"] = {"enabled": False}
    if adapters is not None:
        config["adapters"] = {"enabled": True, "rank": LORA_RANK,
                              "pool_slots": LORA_POOL_SLOTS}
    engine = deepspeed_tpu_torch.init_inference(
        model=model, model_parameters=base, config=config
    )
    for name, state in (adapters or {}).items():
        engine.load_adapter(name, adapter_state=state)
    return engine


def run_batch(engine, prompts, names, max_new):
    """One batch of requests, ``names[i]`` the adapter of prompt i."""
    t0 = time.monotonic()
    reqs = [engine.submit(p, max_new_tokens=max_new, adapter=n)
            for p, n in zip(prompts, names)]
    engine.scheduler.run_until_idle()
    torch.cuda.synchronize()
    out = [r.result() for r in reqs]
    return out, engine_stats(engine, time.monotonic() - t0)


def decode_rate(st):
    return (st["tokens"] - st["requests"]) / (st["decode_ms_sum"] / 1e3)


def phase_adapters(seed, card):
    from deepspeed_tpu_torch.adapters import split_lora_params

    log("phase 6: LoRA fine-tune, GPT-2 small, rank 16, bf16, 4 windows")
    model, base, tuned, ft_launches, ft_stats = lora_finetune(seed)
    base = split_lora_params(base)[0]
    adapters = {"tuned": tuned,
                "syn1": synthetic_adapter(base, seed + 11),
                "syn2": synthetic_adapter(base, seed + 12)}
    g = torch.Generator().manual_seed(seed + 3)
    prompts = [torch.randint(0, model.config.vocab_size, (n,),
                             generator=g).tolist()
               for n in (16, 77, 180, 300, 40, 120, 250, 64)]
    names = ["tuned", "syn1", "syn2", None] * 2
    base_idx = [i for i, n in enumerate(names) if n is None]

    log("phase 6: warm-up")
    eng = adapter_engine(model, base, "bf16", True, adapters)
    run_batch(eng, prompts[:2], names[:2], 2)
    eng.close()

    log("phase 6: serve 8 requests (3 adapters + base), bf16, fused decode")
    eng = adapter_engine(model, base, "bf16", True, adapters)
    zero_launches()
    out, st = run_batch(eng, prompts, names, 32)
    serve_launches = read_launches()
    snap = eng.load_snapshot()
    eng.close()
    steps = st["decode_steps"]
    log(f"  launches {serve_launches} stats {json.dumps(st)}")
    want = {"sgmv": 4 * N_LAYER * steps, "paged_decode": N_LAYER * steps,
            "flash_fwd": N_LAYER * st["cold_prefills"]}
    for name, n in want.items():
        if serve_launches[name] != n:
            fail(f"adapter serving: {name} launched {serve_launches[name]} "
                 f"times, want {n} ({steps} decode steps, "
                 f"{st['cold_prefills']} cold prefills)")
    log(f"  sgmv launched {serve_launches['sgmv']} = 48 x {steps} decode "
        "steps")
    if st["requests"] != 8 or any(len(o) != 32 for o in out):
        fail(f"adapter serving: expected 8 x 32 tokens, got "
             f"{[len(o) for o in out]}")
    if snap["adapter_requests"] != {"tuned": 2, "syn1": 2, "syn2": 2}:
        fail(f"adapter serving: per-adapter counts {snap['adapter_requests']}")

    log("phase 6: the same batch on an adapter-free engine")
    eng = adapter_engine(model, base, "bf16", True, None)
    zero_launches()
    plain_out, plain_st = run_batch(eng, prompts, [None] * 8, 32)
    if read_launches()["sgmv"]:
        fail("the adapter-free engine launched sgmv")
    eng.close()
    for i in base_idx:
        if out[i] != plain_out[i]:
            fail(f"request {i} (base model) differs from the adapter-free "
                 "engine's tokens")
    if all(out[i] == plain_out[i] for i in range(8) if names[i] != "tuned"):
        fail("the synthetic adapters did not change any request's tokens")
    log(f"  base requests {base_idx} equal the adapter-free engine's")

    log("phase 6: mixed batch vs solo runs (prefix cache off)")
    eng = adapter_engine(model, base, "bf16", True, adapters,
                         prefix_cache=False)
    mixed, _ = run_batch(eng, prompts, names, 16)
    for i, (p, n) in enumerate(zip(prompts, names)):
        solo = eng.generate([p], max_new_tokens=16, adapter=n)[0]
        if solo != mixed[i]:
            fail(f"request {i} (adapter {n}): the mixed batch differs from "
                 "its solo run")
    eng.close()
    log("  mixed == solo for all 8 requests")

    log("phase 6: float32, fused decode on and off")
    outs = []
    for fused in (True, False):
        eng = adapter_engine(model, base, "fp32", fused, adapters)
        outs.append(run_batch(eng, prompts, names, 32)[0])
        eng.close()
    for i, (a, b) in enumerate(zip(*outs)):
        if a != b:
            step = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            fail(f"request {i} (adapter {names[i]}): fused and unfused "
                 f"greedy tokens differ at step {step}")
    log("  fused == unfused for all 8 requests")

    log("phase 6: profile of a warm adapter decode window")
    from torch.profiler import ProfilerActivity, profile

    eng = adapter_engine(model, base, "bf16", True, adapters)
    _, warm_st = run_batch(eng, prompts[:2], names[:2], 2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _, prof_st = run_batch(eng, prompts, names, 16)
        wall_ms = (time.monotonic() - t0) * 1e3
    eng.close()
    prof_steps = prof_st["decode_steps"] - warm_st["decode_steps"]
    prof = device_breakdown(prof, wall_ms)
    sgmv_ms = prof["device_ms_by_own_kernel"]["sgmv_kernel"]
    sgmv_share = sgmv_ms / prof["device_busy_ms"]
    log(json.dumps({"adapter_profile": prof}))
    log(f"  sgmv {sgmv_ms:.3f} ms of {prof['device_busy_ms']:.3f} ms device "
        f"busy ({sgmv_share:.4f}) over {prof_steps} decode steps "
        f"({sgmv_ms / prof_steps:.4f} ms a step) in a {wall_ms:.1f} ms "
        f"window on {card}")

    stats = {
        "finetune": ft_stats,
        "ttft_ms_mean": st["ttft_ms_mean"],
        "decode_tokens_per_s": decode_rate(st),
        "decode_steps": steps,
        "cold_prefills": st["cold_prefills"],
        "no_adapters_ttft_ms_mean": plain_st["ttft_ms_mean"],
        "no_adapters_decode_tokens_per_s": decode_rate(plain_st),
        "sgmv_launches_per_decode_step": serve_launches["sgmv"] / steps,
        "profile_sgmv_device_ms": sgmv_ms,
        "profile_sgmv_us_per_launch": sgmv_ms * 1e3
        / max(1, prof["calls_by_own_kernel"]["sgmv_kernel"]),
        "profile_sgmv_share_of_busy": sgmv_share,
        "profile_decode_steps": prof_steps,
        "profile_sgmv_ms_per_decode_step": sgmv_ms / prof_steps,
        "profile_device_busy_ms": prof["device_busy_ms"],
        "profile_device_idle_share": prof["device_idle_share"],
        "profile_wall_ms": wall_ms,
    }
    log(f"  TTFT mean {st['ttft_ms_mean']:.3f} ms with adapters, "
        f"{plain_st['ttft_ms_mean']:.3f} ms without; decode "
        f"{stats['decode_tokens_per_s']:.1f} tokens/s with, "
        f"{stats['no_adapters_decode_tokens_per_s']:.1f} without, on {card}")
    return ({"adapters_finetune": ft_launches,
             "adapters_serve": serve_launches}, stats)


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
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log(f"    {line.strip()}")
    phase_sass()

    kernels = phase_kernels(device, args.seed)
    phase_train_kernels(device, args.seed, kernels)
    phase_sgmv_kernels(device, args.seed, kernels)
    serve_launches, slice_stats = phase_slice(args.seed, smi)
    launches, train_stats = phase_train(args.seed, smi)
    adapter_launches, adapter_stats = phase_adapters(args.seed, smi)
    for path, counts in [("serve", serve_launches),
                         *adapter_launches.items()]:
        for name, n in counts.items():
            launches[name][path] = n
    for name, by_path in launches.items():
        kernels[name]["launches"] = sum(by_path.values())
        kernels[name]["launches_by_path"] = by_path
    kernels["flash_fwd"]["launches_per_cold_prefill"] = (
        serve_launches["flash_fwd"] / slice_stats["cold_prefills"]
    )
    kernels["paged_decode"]["launches_per_decode_step"] = (
        serve_launches["paged_decode"] / slice_stats["decode_steps"]
    )
    kernels["sgmv"]["launches_per_decode_step"] = (
        adapter_stats["sgmv_launches_per_decode_step"]
    )
    # device time of one decode step's 48 launches, from the profiled
    # window of the main path (L2 warm, as decode finds it)
    kernels["sgmv"]["decode_step_ms"] = (
        adapter_stats["profile_sgmv_ms_per_decode_step"]
    )
    log(json.dumps({"slice": slice_stats, "train": train_stats,
                    "adapters": adapter_stats, "card": smi}))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

"""Chip smoke test for the PyTorch/CUDA port (deepspeed_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N]

``--only-decode`` runs phases 1 and 2 for the paged decode kernel alone
and its checks and timings of phase 3 (through the public wrapper only),
so that a copy of this script placed at the root of another checkout of
the repo (an older commit) times that checkout's kernel the same way.
``--only-flash`` does the same for the three flash kernels (bf16, causal)
at D = 64, 128 and 256, and the float32 (FMA) forward at the same shapes,
with ptxas's registers and spills.
``--only-kernels`` does the same for LAMB phase 1 and SGMV: their timings
of phases 3b and 3c (both SGMV forms where the checkout has the epilogue
form), the wrappers' host microseconds a call and the kernel launches of
one fused apply_lora call.

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. probe   — require CUDA; print the card's name and power limit.
  2. build   — compile every CUDA kernel of the three slices from csrc/
               (one nvcc per source, all started together) and print the
               seconds, ptxas's registers and spills per kernel, and the
               count of HGMMA (wgmma) and UTMALDG (TMA load) instructions
               in each kernel's SASS (cuobjdump -sass); fails unless the
               tensor-core forward, dQ and dK/dV have 6 bfloat16/float16
               instantiations each (D = 64, 128, 256), every one holding
               both, or if ptxas spilled in the forward, dQ or dK/dV at
               D = 128 or in dK/dV at D = 256. Then
               torch.profiler's kernel names show which kernel a D = 256
               call launches: bf16/fp16 the tensor-core kernels, float32
               the FMA ones (ops/attention.py:flash_route).
  3. kernels — each kernel against its plain PyTorch version on the same
               inputs, float32 and bfloat16, at the serving path's shapes
               (plus a key-mask case, a fully masked row, a dead slot and
               a NULL page mid-table), with the tolerances below; then
               each kernel's time beside its plain version's, one PyTorch
               library call's where there is one, and its bound. The
               forward and its SDPA yardstick are timed both ways (``ms``
               and ``device_ms``, see Timer). Paged decode is also checked
               and timed at a long-context shape (8 slots all at position
               1023) and bitwise against itself over 10 calls, with its
               wrapper's host time per call.
     3b. training kernels — at GPT-2 small's training shape (B=8, H=12,
               S=1024, D=64, causal): the forward with dropout, dQ and
               dK/dV with and without a padding mask and dropout, in
               f32, bf16 and fp16, and LAMB phase 1 over GPT-2 small's
               real parameters (f32, bf16 and fp16 grads; FusedLamb's
               trust ratios against the plain Lamb's). Then their times,
               bounds and library yardsticks (SDPA forward and backward,
               timed only); the attention kernels and their yardsticks
               both ways, at dropout 0.1 and at 0 (the hash's share);
               LAMB phase 1 both ways (all 148 tensors in one launch, the
               largest leaf launch and the packed launch), with the share
               of its byte bound the device time reaches; a launch on the
               same tensors must build (upload) no device table.
     3c. sgmv  — the SGMV kernel in both forms against their plain
               versions at GPT-2 small's four LoRA target shapes, rank 16,
               B = 8, ids mixing the identity row 0, repeats and the
               highest row, float32 and bfloat16: the float32 delta
               (identity rows exactly zero; in bfloat16 the output must lie
               ten times nearer the plain version, which rounds t, than the
               same arithmetic with t unrounded) and the epilogue form y +
               (scale * delta).to(dtype) (bit for bit what PyTorch's three
               ops give on the kernel's own delta; identity rows leave y
               unchanged); then each form's time (as Timer gives it, and on
               the device alone), its wrapper's host microseconds a call,
               its plain version's time and its bound at B = 8 and B = 64,
               and the host time and kernel launches of apply_lora's fused
               decode path (one launch).
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
               [min_coeff, max_coeff], LAMB's device tables built in the
               first window only), 3 windows of Adam in real float16
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
               identical greedy tokens; kernel launches per decode step
               with and without adapters (torch.profiler over decode-only
               steps); TTFT and decode tokens/s with and without the
               adapters block; SGMV's share of a profiled decode window.
  7. head dims — the flash forward and backward at d = 32, 48 and 96
               (zero-padded to the kernels' 64 or 128) and at d = 192 and
               256 (the D = 256 kernels, every dtype, B*H 32, S 1024,
               with SDPA timed beside them), the tensor-core kernels
               at D = 128 (bf16, B=8 H=6 S=1024, causal: each against
               its plain version, then timed as at D = 256), and paged
               decode at hd 16, 32, 48, 80, 96 and 112 and at the tails
               8, 12, 40 and 72
               (rows that are not whole 16-byte chunks), against their
               plain versions, with their times; then GPT-2s of 768 over
               24 heads (head dim 32), 4 heads (head dim 192) and 6 heads
               (head dim 128, the D = 128 kernels' first engine path), cut
               to 2 layers, through one training micro-step (each
               attention kernel launched once a layer; float32 gradients
               through the kernels equal the plain versions', and at head
               dims 128 and 192 bfloat16 ones too, within the scaled
               tolerance per parameter, both paths reported against
               float32 gradients of the same weights) and serving (a
               300-token cold prefill through the flash forward; fused
               decode at head dims 32 and 128, float32 fused == unfused;
               the gathered decode at 192, above the paged decode kernel's
               128), and 768 over 96 heads (head dim 8) served with fused
               decode through the tail path (float32 fused == unfused);
               the first token the full forward's argmax each time.
  8. telemetry — GPT-2 small at full width and depth (FusedLamb, bf16,
               8 windows) through initialize() with the full telemetry
               block (jsonl and Prometheus exporters every 4 windows, the
               watchdog, tracing at sample rate 1, a profiler window over
               windows 1-2), tensorboard, wall_clock_breakdown and
               memory_breakdown, beside the same run without them, in the
               order off, on, on, off: the step median over windows 3-7,
               and the device-to-host copies of the two profiled
               non-export windows, which must not grow with telemetry on.
               Everything the telemetry wrote to a temporary directory is
               read back: metrics.jsonl with every name of the training
               catalog (train/hbm_peak_bytes equal to
               torch.cuda.max_memory_allocated(), train/model_tflops
               6 N tokens/s), metrics.prom, the Chrome span trace (one
               train.window a window), the profiler trace (the
               window_fwd_bwd and window_optimizer_update ranges, with the
               flash forward, dQ and dK/dV kernels launched inside the
               first and LAMB's inside the second) and the monitor's
               Train/* scalars at every step (TensorBoard event files, or
               events.jsonl without the tensorboard package); the
               watchdog reports no stall. Then the phase 4 requests served
               with tracing off, on, on, off: TTFT and decode tokens/s,
               the same greedy tokens, one request, queue and prefill span
               per request and a span per decode step, and the infer/*
               catalog in metrics.jsonl.
  10. resilience — GPT-2 small at full width, cut to CUT_LAYERS (4)
               layers to keep the script inside its limit, with phase 5's
               training config (bf16, 8 x 2 micro-batches of 1024,
               dropout 0.1, Adam, WarmupLR) and the resilience block, every
               checkpoint under one temporary directory (its disk's free
               bytes printed first), deleted at the end. Run A trains 6
               seeded windows; run B trains 3, saves with checkpoint.write
               armed once (io_retries 1), and a fresh engine loads and
               trains 3 more: B's last losses, steps, skips, loss scale and
               LR equal A's bit for bit. Save and load ms (one each),
               bytes per file, MB/s and one sha256 pass's share. Serving
               run B's directory (inference.checkpoint.load_dir, bf16,
               paged KV, fused decode) gives the trained module's greedy
               tokens through the flash forward and paged decode, and
               decode.step armed once finishes every request with one
               driver restart. A truncated optimizer file of the newest
               tag: a latest-driven load lands on the previous tag
               (corruption_fallbacks 1), an explicit one fails. FusedLamb
               2 + 2 windows, reloaded into the same engine (no LAMB table
               built) and into a fresh one, bit for bit. The supervisor
               heals grads.nan at window 4 from the window-3 checkpoint
               (one rollback; A's losses bit for bit) and escalates a
               persistent fault (SupervisorEscalation). A SIGTERM sent
               during a window commits preempt_global_step<N> at the next
               boundary (preemption_saves 1), and the handler's removal
               restores the disposition. A rank-16 LoRA fine-tune (2
               windows) saves only the adapter (196,608 parameters a
               layer and their moments); load_adapter(load_dir=) decodes
               what load_adapter(adapter_state=) does, 4 SGMV launches a
               layer and decode step, and a rank-8 pool refuses it. The
               launch counts of phases 10 and 11 are per CUT_LAYERS.
  11. data and remat — GPT-2 small at full width, cut to CUT_LAYERS
               layers, with phase
               5's training config (bf16, 8 x 2 micro-batches of 1024,
               dropout 0.1, WarmupLR), its data synthetic token ids from
               --seed passed to initialize() as training_data. (a) The
               data_pipeline block (2 staging buffers: the engine's stager
               over the loader's pinned batches, copied on a copy stream)
               against the same loader's windows fed as lists, 7 windows
               of Adam a run, in the order lists, staged, staged, lists:
               losses, parameters and the seed generator equal bit for
               bit; the step ms (median of windows 5-7 of both runs) and
               the device's idle share over profiled windows 2-3 for
               both; the stager's copy stream must not be the compute
               stream, and the staged runs' Chrome traces must show no
               host-to-device copy on the compute stream. In window 4 of
               each staged run a spin kernel holds the compute stream
               for about a second, and the copy of the window staged
               meanwhile must finish while it is still held (the copy
               runs on the copy stream, overlapping compute). Then the
               same at one micro-batch a window (6 windows, lists then
               staged), where the loader stages its own batches and
               train_batch adds no stager: bit for bit, the step ms, and
               the same probe on the loader's stager in window 3. (b)
               Remat off,
               "full" and
               "dots_with_no_batch_dims_saveable+flash_out+flash_lse", 4
               windows of FusedLamb a run, in the order off, full,
               selective, selective, full, off: the peak memory (reset
               before each), the step ms, the launches (the forward
               1, 2 and 1 a layer and micro-step, dQ and dK/dV 1), the
               losses
               equal to remat off's bit for bit and the peak under "full"
               below remat off's; then one float32 micro-step under each
               remat mode, its gradients through the kernels against the
               plain versions' (as phase 5). (c) A supervised staged run of
               the phase 10 float-weighted GPT-2 fed by the loader through
               a ReplayableDataSource (loader.iter_from), checkpointed after
               window 2: grads.nan in window 3 and then one staging.worker
               death each roll it back, and its losses, parameters and seed
               generator equal an unpoisoned run's bit for bit.
  12. BERT and the optimizer state layouts — (a) the flash forward, dQ
               and dK/dV non-causal at BERT-large's shape (B=8, H=16,
               S=512, D=64) with a padding mask of ragged lengths and a
               dead row, dropout 0 and 0.1, float32, bfloat16 and float16,
               against their plain versions at phase 3b's tolerances (the
               dead row exact zeros); the same under the mask patterns
               (lengths at the key tiles' edges, left padding, holes, a
               dead row) at D = 64, 128 and 256, and an all-ones mask bit
               for bit no mask in bf16; their times (rows 1b-3b) beside
               SDPA with the same boolean mask, the bound of this mask's
               visible pairs and the shares of empty, full and mixed key
               tiles; flash against mha_reference, forward and
               backward, at seq 128, 256, 384 and 512 (where
               FLASH_MIN_SEQ belongs). (b) BERT-large (24 x 1024, 16
               heads, vocab 30592) pretraining at seq 512 through
               initialize(): lengths drawn in 128-512, 15% masked-LM
               labels, NSP labels, bf16, dropout 0.1, FusedLamb, 8 x 2
               micro-batches, 4 windows on one batch: the loss finite and
               falling, 24 forward, dQ and dK/dV launches a micro-step and
               LAMB's launches a step (6), step ms, peak memory and a
               profiled window's idle share; then one float32 micro-step
               of BERT-large cut to 2 layers, gradients through the
               kernels against the plain versions. (c) BERT-large QA at
               seq 384, Adam, 3 windows (the loss falls), then the
               trained module's train=False start/end logits through the
               kernels against the plain versions. (d) GPT-2 small at
               phase 5's shape, weights on the bf16 grid, 3 windows each
               of Adam (fp32 state), bf16 and int8 moments, compensated
               masters, bf16 parameters without codes, optimizer offload,
               Lion and SGD (momentum 0.9): step ms and peak memory (reset
               before each run); every loss finite and falling; offload
               equal to the fp32 Adam run bit for bit (losses, masters,
               published parameters); compensated nearer the fp32 run
               (parameters and losses) than bf16 parameters without
               codes; int8 and offload save, and a fresh engine loads and
               trains one window bit for bit (offload's state back in
               pinned memory). ``--only-phase12`` builds the kernels and
               runs this phase alone.
  13. the rest of inference — GPT-2 small at full width and depth
               (random N(0, 0.02) weights from --seed), each check in
               float32 for the token equality, then bf16 for the times;
               a bf16 trajectory that parts from another route's is
               reported (request, step, the target's top-2 logit gap
               there) and the gap must lie under BF16_FLIP_TOL. (a) The
               contiguous cache (kv_block_size 0, 8 slots, max_seq_len
               1024): 8 prompts of 128-512 tokens, 32 new tokens each,
               the last joining mid-decode; float32 tokens equal the
               paged engine's (fused decode) and the full forward's
               greedy rollout; bf16: flash_fwd 12 launches a cold
               prefill, no paged decode, TTFT, decode tokens/s and the
               cache's bytes. (b) The host tier (kv_block_size 16, fused
               decode, lazy_alloc, max_bytes 2 GiB, a 144-page pool): 24
               requests in 3 waves over three 512-token templates with
               32-128-token suffixes, 192 new tokens each; spills,
               promotions and preemptions each > 0, every promoted page
               (up to 64) equal to its spilled bytes bit for bit, float32
               tokens equal to a 512-page pool's; a second engine in the
               share group warms its first templated request from its
               peer (peer_fetches > 0); multi-LoRA with 3 adapters and 2
               pool rows, the evicted adapter parked and auto-loaded
               (its generation restored, tokens equal the all-resident
               run's; SGMV launches counted); host_tier.copy armed once:
               the template serves cold and copy_faults is 1. bf16: TTFT,
               decode tokens/s, ms a page spilled and promoted. (c)
               Speculative decoding (k = 4, kv_block_size 16, max_seq_len
               512): the GPT-2 small target with blocks 3-12's output
               projections and biases zero, with the agreeing draft (its
               first 2 blocks) and an independent random 2 x 768 draft; 8
               prompts of 128-256 tokens, 64 new tokens each; float32
               tokens equal the non-speculative engine's; bf16:
               acceptance, tokens a target step, decode tokens/s against
               the non-speculative engine, and the draft's flash_fwd
               launches a prefill (2). The launches of (a)-(c) go under
               the paths "contig", "host_tier" and "spec".
  14. data parallel — (a) the DS_TPU_* environment at world size 1
               reaches init_distributed through initialize(
               dist_init_required=True): the group is NCCL, the port's
               all-reduce, reduce-scatter and all-gather leave one rank's
               CUDA tensors as they are, and GPT-2 small trains 3 windows
               at ZeRO stage 2 (paths "dp_nccl1"). (b) Two ranks share the
               one card over a gloo group this phase makes (NCCL refuses
               two ranks on one device), each a subprocess of this script
               loading the kernels phase 2 built, under a timeout: GPT-2
               small at full width and P14_LAYERS blocks (4; 12 until
               phase 18 came, 6 until phase 20), micro-batch 4 a rank
               (8 rows a step),
               float32 Adam at stages 0-3, bfloat16 Adam at stages 0-3
               and FusedLamb at stages 1 and 3, P14_WINDOWS windows each
               (2; 3 until phase 17 came). Every rank returns the global loss; float32
               stages 1-3 equal stage 0 and the dp = 2 run equals a dp = 1
               run over the same 8 rows (rtol 2e-4); bfloat16 losses fall;
               flash forward, dQ and dK/dV launch once a block and
               micro-step on each rank and lamb_phase1 on the shards under
               FusedLamb
               (paths "dp2_rank0", "dp2_rank1"); the stage-3 gauges equal
               the accounting from the shapes; each rank's memory after
               initialize() and peak over the windows, per stage. The
               float32 stage-1 run saves a checkpoint (one optimizer file a
               rank), which a dp = 1 engine loads with the same eval
               fingerprint (rtol 1e-5). Times here are two processes
               sharing one card and its host, not a dp = 2 speed.
  15. the launcher and the lifted refusals — (a) ``python -m
               deepspeed_tpu_torch.launcher.runner --num_gpus 1`` starts
               this script's rank (``--phase15-rank``), which parses its
               arguments with add_config_arguments and calls
               initialize(args=...): bound to cuda:0 from LOCAL_RANK, an
               NCCL group, GPT-2 small at full width and depth (bf16,
               FusedLamb, ZeRO stage 2, 2 windows; launches as phase 14a:
               12 of each attention kernel a micro-step, 6 LAMB a step;
               path "launcher_rank0"); a second launch whose rank exits 3
               must make the runner exit 3. (b) Phase 14b's two gloo ranks
               on the one card (``--phase15b-rank``): bf16 compensated
               masters at stages 1 and 2, the adapters block (rank 16,
               float32) at stages 0-3, and stage 3 with remat "full" and
               "nothing_saveable+zero3_gathered" (float32), P14_WINDOWS
               windows of P14_LAYERS blocks each (the remat runs launch
               the forward twice a layer);
               each equals its dp = 1 run over the same 8 rows at
               P14_RTOL, the tagged stage-3 run "full"'s (paths
               "a6b_dp2_rank0/1"). (c) One process: BERT-large at seq 512
               with LoRA factors (rank 16) on BERT_LENGTHS rows, one
               float32 micro-step: 24 launches of each attention kernel,
               the factors' gradients within TOL[float32] x max|plain| of
               the plain versions' (path "bert_lora"); BERT-large with
               use_flash=False: no flash launch, and its loss equal to the
               flash route's through the plain versions (rtol 1e-5; path
               "bert_no_flash"); GPT-2 small with stochastic_mode in bf16
               trains 3 windows of Adam (finite losses, 12 launches a
               micro-step; path "stochastic") and its LayerNorm output
               differs from the default path's.
  16. tensor parallel — two ranks on the one card over a gloo group the
               phase makes (``--phase16-rank``), a model line of GPT-2
               small at full width and depth at mp 2 (6 heads and 25,152
               vocab rows a rank, initialize(param_specs=partition_specs(
               model))), 2 rows x 1024 a micro-step, 2 micro-steps a
               window, 2 windows: (a) bf16 FusedLamb, dropout 0.1, ZeRO
               stage 2: the same losses on both ranks, 12 launches of each
               attention kernel a micro-step and 6 of LAMB a step on each
               rank (paths "mp2_rank0", "mp2_rank1"), the memory a rank
               holds after initialize() and its peak, the window seconds
               (two ranks on one card over gloo: not an mp 2 speed); the
               flash forward, dQ and dK/dV at the rank's shape [2, 6, 1024,
               64] and LAMB phase 1 over the rank's parameter shards
               against their plain versions (phase 3b's tolerances). (b)
               float32 Adam at dropout 0: losses and whole parameters
               equal an mp 1 run in this process (P16_RTOL, atol 1e-5);
               its checkpoint loads at mp 1 with the same eval
               fingerprint (rtol 1e-5); GPT-2's blocks through the
               activation API's checkpoint with partition_activations off
               and on: the same loss and gradients, the peak lower.
  17. serving over the model axis and sequence parallelism — two ranks
               on the one card over a gloo group the phase makes
               (``--phase17-rank``). (a) GPT-2 small at full width and
               depth served at mp 2 (``mesh: {"model_parallel_size":
               2}``, 6 heads a rank; rank 0 leads, rank 1 follows its
               plans): the paged pool with fused decode, three rank-16
               adapters and the base in one batch of four prompts (40 to
               200 tokens, 24 new), float32 and bf16; the flash forward,
               paged decode and SGMV launched on each rank (paths
               "serve_mp2_<dtype>_rank0/1"), the bytes a rank holds for
               weights, KV pool and adapter pool; float32 tokens equal
               the mp 1 engine's, bf16 may part only at a near-tie
               (BF16_FLIP_TOL). (b) GPT-2 small at full width and depth,
               seq 1024, trained at sp 2 on phase 16's batches (2 rows a
               micro-step, 2 micro-steps, 2 windows): bf16 FusedLamb with
               dropout 0.1 through Ulysses (12 launches of each attention
               kernel a micro-step on each rank, all at [2, 6, 1024, 64])
               and through the ring (no attention kernel: plain score
               blocks), 6 LAMB launches a step (paths
               "sp2_<run>_rank0/1"); float32 Adam at dropout 0 through
               both, whose losses equal sp 1's in this process (P14_RTOL);
               the held memory and peak a rank. Then each kernel at these
               sharded shapes against its plain version (phase 3's
               tolerances). The all-reduces, all-to-alls and hops go
               through host memory (gloo), so no time here is an mp 2 or
               sp 2 speed.
  18. mixture-of-experts and the pipeline — GPT-2 small at full width and
               depth, seq 1024, one fixed batch of 8 rows, 2 windows of
               one micro-step. (a) In this process, 8 MoE experts a
               block, top-2, capacity 1.25 (320 slots a row and expert;
               521.2 M parameters): bf16 FusedLamb with dropout 0.1 and
               float32 Adam, each attention kernel launched 12 times a
               micro-step at [8, 12, 1024, 64], LAMB 6 times a step,
               ``last_aux`` finite with the router loss above 0 and the
               loss falling; then the dense model's float32 Adam (pp 1's
               reference). (b) and (c) on two ranks of the card over a
               gloo group (``--phase18-rank``): float32 Adam on the MoE
               model with its experts over a data axis of 2 (4 a rank,
               the tokens through an all-to-all; 12 launches a
               micro-step at [4, 12, 1024, 64]), whose losses equal (a)'s
               float32 run (P18_RTOL); the pipe axis of 2 (6 blocks a
               stage, 4 microbatches of 2 rows): float32 Adam at dropout
               0, whose losses equal pp 1's, and bf16 FusedLamb with
               dropout 0.1; each stage launches each attention kernel 24
               times a micro-step at [2, 12, 1024, 64] (paths
               "p18_<run>[_rank0/1]"). Then each kernel at these shapes
               against its plain version (phase 3's tolerances; LAMB over
               an expert rank's ``expert_in_w`` group). Gloo sends every
               collective through host memory, so no time here is a dp 2
               or pp 2 speed.
  19. what a sequence and a model axis lifted, and the tile autotuner —
               on two ranks of the card over a gloo group
               (``--phase19-rank``): (a) BERT-large pretraining (1024
               wide, 16 heads, seq 512, phase 12's padded batches, cut to
               P19_BERT_LAYERS = 2 layers) at a sequence axis of 2:
               float32 Adam, whose losses equal sp 1's in this process,
               and bf16 FusedLamb with dropout 0.1, whose loss falls;
               Ulysses runs rows 1b-3b once a layer a micro-step at [8, 8,
               512, 64], LAMB 6 launches a step; (b) phase 18's MoE GPT-2
               small at a model axis of 2 (dp 1), float32 Adam, whose
               losses equal one rank's, 12 launches a micro-step at [8,
               6, 1024, 64]; (c) GPT-2 small at a sequence axis of 2 with
               int8 moments (float32 Adam, equal to sp 1) and with int8
               moments and compensated masters (bf16, dropout 0.1, the
               loss falling) (paths "p19_<run>_rank0/1"). Then the
               kernels at (a)'s and (b)'s shapes against their plain
               versions, and (d) the tile autotuner
               (ops/autotune.py) at [8, 12, 1024, 64] and [8, 6, 1024,
               128] (bf16, causal): its table, each forward form against
               the plain version (phase 3's tolerances) and timed. No
               time of (a)-(c) is an sp 2 or mp 2 speed (gloo).
  20. the serving fleet on one host (serving/) — GPT-2 small at full
               width and depth (random N(0, 0.02) weights from --seed),
               paged KV with fused decode and the prefix cache, prefill
               window 256 (the flash forward). (a) init_fleet with 2
               in-process replicas and prefix affinity serves 16 requests
               (4 templates of 2-3 pages x 3 tails, 4 of their own, 24
               new tokens), bf16 and float32: float32 tokens equal one
               engine's, bf16 part only at a near-tie (BF16_FLIP_TOL);
               affinity hits above 0; every fleet/* stream of
               SERVING_METRICS present; the flash forward's and paged
               decode's launches through the fleet equal 12 a cold
               prefill and 12 a decode step of its engines' own counts.
               (f) serve_http on 127.0.0.1:0 in front of (a)'s float32
               router: 2 SSE streams, the first event while the request
               still holds its slot, the tokens (a)'s. (b) a rolling
               restart of (a)'s router under 8 clients' 16 requests at
               capacity_floor 0.5: each answered once with (a)'s tokens,
               fleet/replicas_available never under 1, the card's peak
               printed. (c) brownout (a FleetRouter of 2 slots and a
               queue of 8 a replica, band 0.25-0.9, its periodic refresh
               off): priority-1 requests clamped to 4 tokens, priority 0
               not, no prefix page registered in the band while a
               template's hit still serves, registration back after it.
               (d) adapter affinity: replica 0 holds adapters a, b and
               replica 1 c, d (synthetic rank 16); each adapter request
               served by its holder, SGMV 48 launches a decode step,
               float32 tokens equal one engine's with the four adapters.
               (e) the subprocess backend: the weights saved through the
               port's checkpoint, one worker process serving them on the
               card from inference.checkpoint.load_dir: float32 tokens
               equal (a)'s, its log reporting cuda, the process reaped;
               the launches it logs at exit equal 12 a cold prefill and
               12 a decode step of its engine's counts, read over the
               pipe before shutdown; its round trip a request against
               (a)'s. Every sub-phase fails on an eviction, reroute,
               breaker open or zombie restart it did not cause and on a
               request served off the card (paths "p20<sub-phase>_*").
               Then each kernel against its plain version at the phase's
               shapes (phase 3's tolerances), float32 and bf16: the flash
               forward at [1, 12, 256, 64] causal, without a mask and
               with padding keys masked; paged decode at 8 slots over 32
               pages a slot; SGMV and its epilogue form at rank 16 over
               4 adapters on each of the 4 targets.
  21. the networked fleet and its control plane (serving/transport.py,
               node.py, journal.py, autoscaler.py, telemetry/hub.py) —
               GPT-2 small at full width and depth in float32, its
               weights through the port's checkpoint, paged KV with
               fused decode and the prefix cache, prefill window 256.
               One node agent process (``python -m
               deepspeed_tpu_torch.serving.node --spec-file ... --port
               0``, its stderr in a file printed on failure) hosts r0 and
               r1 on the card. (a) init_fleet's socket backend with
               prefix affinity serves phase 20's 16 requests: each
               answered once (the node's own counts agree) with one
               in-process engine's tokens; TTFT, tokens/s and a
               request's round trip over the socket. (b) conn.reset and
               frame.corrupt, each once, while 8 requests stream: none
               lost, none run twice on the node, tokens (a)'s. (c)
               serving.journal, and router.crash (SIGKILL) in a router
               process of its own once its 4 requests stream; a second
               init_fleet on the journal comes up at epoch + 1, adopts r0
               and r1 with no engine built, the old epoch's control op
               is fenced out, and the journalled requests finish with
               (a)'s tokens, each run once on the node. (d)
               serving.autoscale (min 1, max 2, the socket provider)
               from r0 alone: a burst spawns a GPT-2 engine inside the
               node on the card, idle retires it; the node's allocated
               memory (its log) after its start, the spawn and the
               retire, where the retire must leave less than one
               engine's weights held, and the card's used memory before,
               after the spawn and after the retire (nvidia-smi's row for
               the node where it lists one). (e) serving.hub: the door's
               /metrics and /statz answer 200 with the node's replica
               series. The node's launches, logged at its exit, equal 12
               a cold prefill and 12 a decode step of its engines'
               counts (path "p21"); no node process is left. Then the
               flash forward and paged decode against their plain
               versions at phase 20's shapes.
  22. int8 moments across ranks, uneven microbatches, serving over a
               data axis — GPT-2 small at full width, float32, gloo ranks
               of the card (``--phase22-rank``, ``--phase22c-rank``). (a)
               Adam with int8 moments at a pipe axis of 2 and with the
               MoE experts over a data axis of 2 at ZeRO stages 0 and 3
               (phase 18's models, batch and windows): losses equal one
               rank's int8 run (P18_RTOL), and rank 0's int8 first moment
               after the first window, joined into the whole JAX leaves
               through the checkpoint's join, equals one rank's
               (P22_SCALE_RTOL, P22_CODE_FLIPS); the card bytes an
               expert rank holds for parameters, gradients and moments
               at stage 3 beside stage 0's; (b) int8 moments at a model axis of 2
               with the optimizer offloaded, against mp 1 (the same
               checks; the card's and the host's bytes a rank holds);
               (c) a pipe axis of 2 by a data axis of 4 (eight ranks), 2
               blocks, 12 global rows in 2 microbatches (each rank runs
               a 3-row piece of one), one window, against pp 1 on the
               same batch, each rank's plan checked, then again in the
               same processes with int8 moments at ZeRO stage 3 against
               pp 1's int8 run (losses and the joined int8 state as in
               (a)), each rank's card bytes beside the float32 stage-0
               run's; (d) serving at a
               data axis of 2 (phase 20's block, one rank-16 adapter, 8
               requests of two templates, the later six hitting their
               pages): float32 tokens equal one engine's, each rank's
               launches of rows 1, 6 and 7 equal 12 (SGMV 48) times the
               leader's cold prefills and decode steps, the bytes a rank
               holds (paths "p22_*"). Then rows 1-3 at (a)-(c)'s float32
               shapes and rows 1, 6, 7 at the serving shapes against
               plain. No time here is a dp, pp or mp speed (gloo).
  9. report  — a JSON line of per-kernel numbers (the D = 256, decode
               tail and BERT (rows 1b-3b) variants in entries of their
               own; the forward's tile forms in "tile_forms" of rows 1
               and 1m; the launches of every path, phases 10 to 22
               included), the nvidia-smi line, then the last line {"ok":
               true, "device": {...}}. It comes after phase 22, and the
               line before the kernels' logs each phase's seconds.

``--only-phase12`` builds every kernel and runs phase 12 alone, printing
its numbers as one JSON line; ``--only-phase13``, ``--only-phase14``,
``--only-phase15``, ``--only-phase16``, ``--only-phase17``,
``--only-phase18``, ``--only-phase19``, ``--only-phase20``,
``--only-phase21`` and ``--only-phase22`` the same for phases 13 to 22. ``--only-bert-attention``
builds the flash kernels, checks them under BERT's padding mask and the mask
patterns of phase 12a, and times rows 1b-3b (copy the script to the root
of an unpacked parent under build/ to time both trees in one call).

``--cold-telemetry`` runs one telemetry-on training run whose first
window builds the kernels in an empty build directory under a 5 s
watchdog: the watchdog arms at the first completed window, so the build
must not read as a stall.

The attention kernels take two routes (ops/attention.py:flash_route):
bfloat16 and float16 the tensor-core forward, dQ and dK/dV kernels
(wgmma + TMA) at D = 64, 128 and 256; float32 the FMA kernels (the
tensor cores take float32 only as TF32).

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
vs plain: max|diff| <= 1e-4 * max|plain| per parameter. LAMB's m, v
and u must equal the plain version's bit for bit. SGMV: float32
atol = rtol = 1e-4; bfloat16 atol = 1e-2 x each output row's largest
magnitude (t is rounded to bfloat16 before the second product, and a
summation in another order can move it by one bf16 ulp, 2**-8 relative),
and its error against the plain version below a tenth of its error
against the unrounded-t arithmetic (which pins where t is rounded); its
epilogue form TOL of its dtype against its plain version (a delta that
differs in its last bits can move the rounded y + scale * delta by one
ulp of y) and bit for bit against PyTorch's ops on the kernel's delta.
"""

import argparse
import collections
import gc
import importlib.util
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import threading
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
# phases 10 and 11 run GPT-2 small's width at this depth, to keep the
# script inside its time limit (their paths do not depend on the depth)
CUT_LAYERS = 4
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


# the last lines log() printed, repeated on stderr by fail()
RECENT = collections.deque(maxlen=40)
T_START = time.monotonic()


def fail(msg):
    """Report ``msg`` on stdout, where the phases log, and on stderr after
    the last lines the phases logged, so that a caller who keeps only the
    end of stderr still sees where and why the script failed; then exit
    1."""
    print(f"FAIL: {msg}", flush=True)
    tail = "\n".join(line[-2000:] for line in RECENT)
    print(f"{tail}\nFAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)
    RECENT.append(str(msg))


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------
class Timer:
    """CUDA-event time of one call, averaged over ``iters`` calls, with the
    50 MB L2 flushed before each (the serving path finds the next layer's
    K/V cold). The stream is idle when the call starts, so the time
    includes the host's enqueue of the call (the Python wrapper, the
    launch). With ``spin=True`` a device spin of ``spin_cycles`` (default
    SPIN_CYCLES, ~0.5 ms) is queued ahead of each call instead, the
    enqueue overlaps it, and the events time the device work alone; the
    spin must outlast the host's enqueue of the call, or its excess is
    counted as device time."""

    SPIN_CYCLES = 1_000_000

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, iters=20, warmup=3, spin=False, spin_cycles=SPIN_CYCLES):
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            if spin:
                torch.cuda._sleep(spin_cycles)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def plain_flash_fwd(*args, block_k=None):
    """``flash_fwd``'s plain version under ``flash_fwd``'s signature, for
    the swaps that run a model's attention through the plain versions
    (the key tile is the kernel's and changes nothing there)."""
    from deepspeed_tpu_torch.ops import attention as A

    del block_k
    return A.flash_fwd_plain(*args)


# the kernels that must run on the tensor cores, by library, and how many
# instantiations of each: every bfloat16/float16 one (2 dtypes x the head
# dims of its tensor-core route, ops/attention.py:flash_route; the forward
# x its five tile forms: 128- and 64-key at D = 64 and 128, 64-key at
# D = 256) holds wgmma (HGMMA) and TMA loads (UTMALDG)
TC_KERNELS = {"flash_fwd": {"flash_fwd_kernel_tc": 2 * 5},
              "flash_bwd": {"flash_bwd_dkv_kernel_tc": 2 * 3,
                            "flash_bwd_dq_kernel_tc": 2 * 3}}
# the tensor-core instantiations whose ptxas report must show no spill
# (mangled-name fragments: the forward in both tile forms, dQ and dK/dV at
# D = 128, dK/dV at D = 256)
NO_SPILL = {"flash_fwd": ("flash_fwd_kernel_tcI13__nv_bfloat16Li128ELi128E",
                          "flash_fwd_kernel_tcI6__halfLi128ELi128E",
                          "flash_fwd_kernel_tcI13__nv_bfloat16Li128ELi64E",
                          "flash_fwd_kernel_tcI6__halfLi128ELi64E"),
            "flash_bwd": ("flash_bwd_dq_kernel_tcI13__nv_bfloat16Li128E",
                          "flash_bwd_dq_kernel_tcI6__halfLi128E",
                          "flash_bwd_dkv_kernel_tcI13__nv_bfloat16Li128E",
                          "flash_bwd_dkv_kernel_tcI6__halfLi128E",
                          "flash_bwd_dkv_kernel_tcI13__nv_bfloat16Li256E",
                          "flash_bwd_dkv_kernel_tcI6__halfLi256E")}
# each redesigned kernel's Timer reading at these shapes before its
# redesign (the FMA attention kernels, at D = 64 and at D = 256; the
# forward, dQ and dK/dV at D = 128 in the 384-thread tensor-core block,
# D128_BEFORE_FORM, which dQ keeps; paged decode with one block per (head,
# slot); H100 80GB HBM3, 700 W; PERF.md), printed beside this run's
# readings, not part of the kernels line
FMA_BEFORE_MS = {"flash_fwd": 2.204, "flash_fwd serve": 0.3129,
                 "flash_bwd_dkv": 3.075, "flash_bwd_dq": 2.065,
                 "flash_fwd d256": 2.281, "flash_bwd_dq d256": 4.746,
                 "flash_bwd_dkv d256": 3.659, "flash_bwd_dkv d128": 0.2419,
                 "flash_fwd d128": 0.1155, "flash_bwd_dq d128": 0.09935,
                 "paged_decode": 0.07853}
# the form each D = 128 reading of FMA_BEFORE_MS was taken of
D128_BEFORE_FORM = {
    "flash_fwd": "the 384-thread kernel with a producer warpgroup, which "
                 "spilled 232 bytes",
    "flash_bwd_dq": "the same 384-thread kernel with a producer "
                    "warpgroup as now, 168 registers, no spill: no "
                    "256-thread form beat it by more than 1%",
    "flash_bwd_dkv": "the 384-thread kernel with a producer warpgroup, "
                     "which spilled 856 bytes"}
ROUTE = {"flash_fwd": "wgmma+tma (bf16, fp16); FMA (float32)",
         "flash_bwd_dq": "wgmma+tma (bf16, fp16); FMA (float32)",
         "flash_bwd_dkv": "wgmma+tma (bf16, fp16); FMA (float32)",
         "flash_fwd d128": "wgmma+tma (bf16, fp16; 128-key tiles, three "
                           "stages, no producer warpgroup); FMA (float32)",
         "flash_bwd_dq d128": "wgmma+tma (bf16, fp16; 64-key tiles, two "
                              "stages, a producer warpgroup: the D = 64 "
                              "form); FMA (float32)",
         "flash_bwd_dkv d128": "wgmma+tma (bf16, fp16; 32-query tiles, "
                               "four stages, tile t's S^T and dP^T ahead "
                               "of tile t - 1's dK/dV products, no "
                               "producer warpgroup); FMA (float32)",
         "flash_fwd d256": "wgmma+tma (bf16, fp16; 64-key tiles, no "
                           "producer warpgroup); FMA (float32)",
         "flash_bwd_dq d256": "wgmma+tma (bf16, fp16; 32-key tiles, no "
                              "producer warpgroup); FMA (float32)",
         "flash_bwd_dkv d256": "wgmma+tma (bf16, fp16; two passes, dK "
                               "then dV, 32-query tiles, no producer "
                               "warpgroup); FMA (float32)"}


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


def ptxas_report(log_text):
    """{mangled kernel: (registers, spill store bytes, spill load bytes)}
    from ptxas's -v report."""
    out, func = {}, None
    regs = stores = loads = 0
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            func = line.split("'")[1]
            regs = stores = loads = 0
        elif func is not None and "spill stores" in line:
            words = line.replace(",", "").split()
            stores = int(words[words.index("spill") - 2])
            loads = int(words[words.index("loads") - 3])
            out[func] = (regs, stores, loads)
        elif func is not None and "Used" in line and "registers" in line:
            words = line.split()
            regs = int(words[words.index("Used") + 1])
            out[func] = (regs, stores, loads)
    return out


def check_spills():
    """Fail if ptxas spilled in an instantiation NO_SPILL names (read from
    the build's saved report). Returns {kernel: (registers, stores,
    loads)} for them."""
    from deepspeed_tpu_torch.ops import kernel_lib

    out = {}
    for name, fragments in NO_SPILL.items():
        path = kernel_lib.library_path(name).with_suffix(".log")
        report = ptxas_report(path.read_text())
        for fragment in fragments:
            hits = {f: r for f, r in report.items() if fragment in f}
            if len(hits) != 1:
                fail(f"{name}: ptxas reported {len(hits)} kernels matching "
                     f"{fragment}")
            (func, (regs, stores, loads)), = hits.items()
            log(f"  {fragment}: {regs} registers, spill stores {stores} "
                f"bytes, spill loads {loads} bytes")
            if stores or loads:
                fail(f"{name}: {fragment} spills ({stores} bytes stored, "
                     f"{loads} loaded)")
            out[fragment] = (regs, stores, loads)
    return out


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
    for name, families in TC_KERNELS.items():
        for fragment, want in families.items():
            tc = {f: c for f, c in out[name].items() if fragment in f}
            if len(tc) != want or not all(h and u for h, u in tc.values()):
                fail(f"{name}: want {want} instantiations of {fragment}, "
                     f"each with HGMMA and UTMALDG instructions: {tc}")
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


def decode_long_case(device, gen, dtype):
    """A long-context decode shape: decode_case's shapes with every slot
    live at position 1023 (64 full pages each, no NULL page)."""
    slots, heads, hd, bs, mb = 8, 12, 64, 16, 64
    pages = slots * mb + 1
    q = torch.randn(slots, heads, hd, device=device, generator=gen).to(dtype)
    kp = torch.randn(pages, bs, heads, hd, device=device, generator=gen).to(dtype)
    vp = torch.randn(pages, bs, heads, hd, device=device, generator=gen).to(dtype)
    perm = torch.randperm(pages - 1, device=device, generator=gen) + 1
    tables = perm.reshape(slots, mb).to(torch.int32).contiguous()
    positions = torch.full((slots,), 1023, dtype=torch.int32, device=device)
    return q, kp, vp, tables, positions


DECODE_CASES = {"bench": decode_case, "long_context": decode_long_case}
DECODE_SHAPES = {
    "bench": "8 slots x 12 heads x hd 64, 16-token pages, 64 pages/slot, "
             "positions 15..1023 (one dead slot, one NULL page), bf16",
    "long_context": "8 slots x 12 heads x hd 64, 16-token pages, all at "
                    "position 1023, bf16",
}


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

    report["paged_decode"] = phase_decode(device, gen, timer)
    return report


def host_us_per_call(fn, calls=200, rounds=5):
    """Host wall time per call of ``fn``, in microseconds: ``rounds``
    rounds of ``calls`` calls back to back, each ended by a synchronize
    (the device keeps up, so the host's call rate is what is measured);
    the median round, since other work on the host's shared cores only
    ever adds time."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(per_call)[rounds // 2]


def phase_decode(device, gen, timer):
    """Paged decode against its plain version (float32 and bfloat16, the
    bench and long-context shapes; a dead slot exact zeros, the NULL page
    mid-table skipped, 10 calls bitwise equal), then its times at both
    shapes in bfloat16: ``ms`` and ``device_ms`` (Timer), the wrapper's
    host microseconds a call, the plain version's time and the bound.
    Uses the public wrappers only. Returns the kernels-line entry."""
    from deepspeed_tpu_torch.ops.decode_attention import (
        paged_flash_decode,
        paged_flash_decode_plain,
    )

    log("phase 3: paged_decode vs plain")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape, case in DECODE_CASES.items():
            q, kp, vp, tables, positions = case(device, gen, dtype)
            out = paged_flash_decode(q, kp, vp, tables, positions)
            torch.cuda.synchronize()
            ref = paged_flash_decode_plain(q, kp, vp, tables, positions)
            tag = f"paged_decode {str(dtype)[6:]} {shape}"
            errs[(dtype, shape)] = check_close(tag, out, ref, dtype)
            for _ in range(10):
                if not torch.equal(
                    paged_flash_decode(q, kp, vp, tables, positions), out
                ):
                    fail(f"{tag}: two calls on the same inputs differ")
            if shape != "bench":
                continue
            if not bool((out[3] == 0).all()):
                fail(f"{tag}: the dead slot is not exact zeros")
            # the NULL page mid-table is skipped: garbage there changes
            # nothing
            kp2 = kp.clone()
            kp2[0] = 1e4
            if not torch.equal(
                paged_flash_decode(q, kp2, vp, tables, positions), out
            ):
                fail(f"{tag}: the NULL page mid-table was not skipped")
    log("  10 calls bitwise equal at every shape and dtype")
    timings = {}
    for shape, case in DECODE_CASES.items():
        q, kp, vp, tables, positions = case(device, gen, torch.bfloat16)
        nbytes, flops = decode_work(q, tables, positions, kp.shape[1])
        b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
        fn = lambda: paged_flash_decode(q, kp, vp, tables, positions)
        timings[shape] = dict(
            shape=DECODE_SHAPES[shape],
            max_abs_err=errs[(torch.bfloat16, shape)],
            max_abs_err_f32=errs[(torch.float32, shape)],
            ms=timer.ms(fn), device_ms=timer.ms(fn, spin=True),
            host_us_per_call=host_us_per_call(fn),
            plain_ms=timer.ms(
                lambda: paged_flash_decode_plain(q, kp, vp, tables, positions)
            ),
            bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
            bound_flops=flops,
        )
        log(f"  paged_decode {shape}: {json.dumps(timings[shape])}")
    head = timings["bench"]
    log(f"  paged_decode: ms {head['ms']:.5f}, device_ms "
        f"{head['device_ms']:.5f}; before_ms {FMA_BEFORE_MS['paged_decode']} "
        "(one block per (head, slot))")
    return dict(
        name="paged_decode", route="cuda", source=DECODE_SOURCE,
        replaces=DECODE_TPU, tpu_kernel=DECODE_TPU,
        **head, device_ms_kind="CUDA events around one call queued behind a "
        "device spin: the kernel alone, without the host wrapper and launch "
        "that ms includes",
        library_ms=None, library=None,
        long_context=timings["long_context"],
    )


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


def lamb_operands(device, gen, seed):
    """GPT-2 small's 148 parameters in LAMB's group order, with float32
    grads and moments from ``gen``: ``(ps, g32, m0, v0, c1, c2, kw,
    [(group, tensors)], {name: param}, [names])``."""
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel
    from deepspeed_tpu_torch.ops.optimizers import (
        bias_corrections, param_groups,
    )

    model = GPT2LMHeadModel(GPT2Config.small(), device=device, seed=seed)
    params = {n: p.detach() for n, p in model.named_parameters()}
    names = [n for grp in param_groups(params).values() for n in grp]
    groups = [(g, len(grp)) for g, grp in param_groups(params).items()]
    ps = [params[n] for n in names]

    def noise(scale):
        return [torch.randn(p.shape, device=device, generator=gen) * scale
                for p in ps]

    g32, m0 = noise(1e-3), noise(1e-4)
    v0 = [x * x for x in noise(1e-3)]
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
              eps_inside_sqrt=False)
    c1, c2 = bias_corrections(0.9, 0.999, 3)
    return ps, g32, m0, v0, c1, c2, kw, groups, params, names


def check_lamb(device, gen, seed):
    """LAMB phase 1 over GPT-2 small's parameters (all 148 tensors in one
    launch) against its plain version, float32 and bfloat16 grads; then
    one FusedLamb step (6 launches) against the plain Lamb on the same
    state. Returns (max relative partial error, max relative trust-ratio
    error, the timing operands)."""
    from deepspeed_tpu_torch.ops.fused_lamb import (
        FusedLamb, lamb_phase1, lamb_phase1_plain,
    )
    from deepspeed_tpu_torch.ops.optimizers import Lamb

    ops = lamb_operands(device, gen, seed)
    ps, g32, m0, v0, c1, c2, kw, groups, params, names = ops

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
            if not all(torch.equal(got, want)
                       for got, want in zip(runs[0][i], runs[1][i])):
                fail(f"{tag}: {what} is not bitwise the plain version's")
        log(f"  {tag}: m, v and u bitwise equal to the plain version's")
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
    return worst_partial, ratio_err, ops


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

    report["lamb_phase1"] = dict(
        time_lamb(device, timer, lamb_ops), max_abs_err=lamb_err,
        max_abs_err_kind="max relative error of the block partials",
        trust_ratio_max_rel_err=ratio_err,
    )
    return report


def lamb_work(ps, gdtype):
    """Bytes and flops of LAMB phase 1 over ``ps``: p, g, m, v read and m,
    v, u written (4 bytes each, g its own size), two float32 partials a
    4096-element block; 16 flops an element."""
    n = sum(p.numel() for p in ps)
    nblocks = sum(max(1, -(-p.numel() // 4096)) for p in ps)
    gsize = torch.empty(0, dtype=gdtype).element_size()
    return n * (6 * 4 + gsize) + nblocks * 8, 16 * n


def time_lamb(device, timer, lamb_ops):
    """LAMB phase 1's times on GPT-2 small's tensors, float32 grads: all
    148 tensors in one launch (the step's 6 launches together), the
    largest leaf launch (row 4: ``h.*.inter_w``'s 12 tensors) and the
    packed launch of the 11 small groups (row 5), each as Timer gives it
    and on the device alone, with its bound and the share of the bound
    the device time reaches. Every launch after the first on the same
    tensors must build no device table (none is uploaded)."""
    from deepspeed_tpu_torch.ops.fused_lamb import (
        lamb_phase1, lamb_phase1_plain,
    )

    ps, g32, m0, v0, c1, c2, kw, groups = lamb_ops[:8]
    ms, vs = [m.clone() for m in m0], [v.clone() for v in v0]
    us = [torch.empty_like(p) for p in ps]
    # (shape, tensor indices) of the three launches
    index, at = {}, 0
    for name, n in groups:
        index[name] = list(range(at, at + n))
        at += n
    small = [i for name, idx in index.items()
             if sum(ps[j].numel() for j in idx) <= 1 << 21 for i in idx]
    launches = {
        "all": (f"GPT-2 small's {len(ps)} tensors in one launch",
                list(range(len(ps)))),
        "leaf": ("row 4, lamb_leaf_update: h.*.inter_w's 12 tensors",
                 index["h.*.inter_w"]),
        "packed": (f"row 5, lamb_multi_tensor_update: the {len(small)} "
                   "tensors of the 11 small groups", small),
    }
    out = {}
    for key, (shape, idx) in launches.items():
        args = ([ps[i] for i in idx], [g32[i] for i in idx],
                [ms[i] for i in idx], [vs[i] for i in idx],
                [us[i] for i in idx], c1, c2, 0.5)
        fn = lambda: lamb_phase1(*args, **kw)
        fn()
        builds = getattr(lamb_phase1, "table_builds", None)
        # the wrapper walks every tensor on the host (up to ~0.9 ms a call
        # for 148 tensors), so the spin that hides its enqueue is 10x the
        # default
        ms_ = timer.ms(fn)
        device_ms = timer.ms(fn, spin=True,
                             spin_cycles=10 * Timer.SPIN_CYCLES)
        if builds is not None and lamb_phase1.table_builds != builds:
            fail(f"lamb_phase1 ({key}): a launch on the same tensors built "
                 f"its device table again ({lamb_phase1.table_builds - builds}"
                 " builds)")
        nbytes, flops = lamb_work(args[0], torch.float32)
        b_ms, b_by = bound(nbytes, flops, torch.float32)
        out[key] = dict(
            shape=shape, ms=ms_, device_ms=device_ms,
            host_us_per_call=host_us_per_call(fn, calls=50),
            bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
            bound_flops=flops, bound_fraction=b_ms / device_ms,
            table_builds_after_first=(None if builds is None
                                      else lamb_phase1.table_builds - builds),
        )
        if key == "all":
            out[key]["plain_ms"] = timer.ms(
                lambda: lamb_phase1_plain(*args, **kw), iters=5, warmup=1)
        log(f"  lamb_phase1 {key}: {json.dumps(out[key])}")
    head = out["all"]
    return dict(
        name="lamb_phase1", route="cuda", source=LAMB_SOURCE,
        replaces=LAMB_TPU, tpu_kernel=LAMB_TPU,
        shape=head["shape"] + f" ({sum(p.numel() for p in ps)} float32 "
        "elements), float32 grads",
        ms=head["ms"], device_ms=head["device_ms"], plain_ms=head["plain_ms"],
        library_ms=None, library=None, bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], bound_bytes=head["bound_bytes"],
        bound_flops=head["bound_flops"],
        bound_fraction=head["bound_fraction"],
        host_us_per_call=head["host_us_per_call"],
        leaf=out["leaf"], packed=out["packed"],
    )


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


def sgmv_work(x, a_pool, b_pool, ids, add=False):
    """Bytes and flops the function needs on these inputs: the DISTINCT
    non-identity adapter rows of A and B read once (id 0 reads nothing),
    x and ids read, and the float32 delta written; 2 * (in * r + r * out)
    flops a non-identity slot. With ``add`` (the epilogue form), y is read
    and y_out written in the pools' dtype instead of the float32 delta,
    and the scale and the add are 2 flops an output."""
    b, din = x.shape
    rank, dout = b_pool.shape[1], b_pool.shape[2]
    id_list = ids.tolist()
    distinct = len({i for i in id_list if i != 0})
    live = sum(1 for i in id_list if i != 0)
    es = x.element_size()
    out_bytes = 2 * b * dout * es if add else b * dout * 4
    nbytes = (distinct * (din * rank + rank * dout) * es + b * din * es
              + b * 4 + out_bytes)
    flops = 2 * live * (din * rank + rank * dout) + (2 * b * dout if add
                                                     else 0)
    return nbytes, flops


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


# the epilogue's LoRA scale alpha / rank (alpha 12 at rank 16): not a
# power of two, so that scale * delta rounds
SGMV_SCALE = 0.75


def check_sgmv_add(tag, x, a_pool, b_pool, ids, delta):
    """The epilogue form against its plain version (TOL of its dtype) and
    bit for bit against PyTorch's scale, cast and add on the kernel's own
    delta; identity rows leave y unchanged. Returns the max error."""
    from deepspeed_tpu_torch.ops.decode_attention import (
        lora_sgmv_add,
        lora_sgmv_add_plain,
    )

    dtype = x.dtype
    gen = torch.Generator(device=x.device).manual_seed(ids.numel())
    y = torch.randn(x.shape[0], b_pool.shape[2], device=x.device,
                    generator=gen).to(dtype)
    out = lora_sgmv_add(x, a_pool, b_pool, ids, y, SGMV_SCALE)
    torch.cuda.synchronize()
    if out.dtype != dtype or out.shape != y.shape:
        fail(f"{tag} add: output {out.dtype} {tuple(out.shape)}")
    err = check_close(tag + " add", out,
                      lora_sgmv_add_plain(x, a_pool, b_pool, ids, y,
                                          SGMV_SCALE), dtype)
    if not torch.equal(out, y + (SGMV_SCALE * delta).to(dtype)):
        fail(f"{tag} add: the epilogue differs from y + (scale * delta)"
             ".to(dtype) on the kernel's own delta")
    zero = (ids == 0).nonzero().flatten()
    if not torch.equal(out[zero], y[zero]):
        fail(f"{tag} add: an identity row changed y")
    return err


def sgmv_forms(x, a_pool, b_pool, ids):
    """The delta form and, where the checkout has it, the epilogue form,
    as zero-argument calls on these operands (y of the output's shape)."""
    from deepspeed_tpu_torch.ops import decode_attention as D

    forms = {"delta": lambda: D.lora_sgmv(x, a_pool, b_pool, ids)}
    if hasattr(D, "lora_sgmv_add"):
        y = torch.zeros(x.shape[0], b_pool.shape[2], dtype=x.dtype,
                        device=x.device)
        forms["add"] = lambda: D.lora_sgmv_add(x, a_pool, b_pool, ids, y,
                                               SGMV_SCALE)
    return forms


def time_sgmv(device, gen, timer, batches=(8, 64)):
    """Each form's time at GPT-2 small's four targets (bf16, rank 16):
    ``ms`` and ``device_ms`` (Timer), the wrapper's host microseconds a
    call (median of 5 rounds of 200 calls), the plain version's time and
    the bound; keyed "<form> <target> B=<b>"."""
    from deepspeed_tpu_torch.ops import decode_attention as D

    shapes = {}
    for b in batches:
        for target, (din, dout) in LORA_SHAPES.items():
            x, a_pool, b_pool, ids = sgmv_case(device, gen, torch.bfloat16,
                                               din, dout, b)
            y = torch.zeros(b, dout, dtype=torch.bfloat16, device=device)
            plains = {
                "delta": lambda: D.lora_sgmv_plain(x, a_pool, b_pool, ids),
                "add": lambda: D.lora_sgmv_add_plain(x, a_pool, b_pool, ids,
                                                     y, SGMV_SCALE),
            }
            for form, fn in sgmv_forms(x, a_pool, b_pool, ids).items():
                nbytes, flops = sgmv_work(x, a_pool, b_pool, ids,
                                          add=form == "add")
                b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
                key = f"{form} {target} B={b}"
                shapes[key] = dict(
                    ms=timer.ms(fn, iters=100),
                    device_ms=timer.ms(fn, iters=100, spin=True),
                    host_us_per_call=host_us_per_call(fn),
                    plain_ms=timer.ms(plains[form]),
                    bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
                    bound_flops=flops,
                )
                log(f"  sgmv {key}: {json.dumps(shapes[key])}")
    # the launch floor the kernel is held against: one PyTorch elementwise
    # kernel on one element, timed the same way
    one = torch.zeros(1, dtype=torch.bfloat16, device=device)
    floor = lambda: one.add_(1)
    shapes["launch_floor"] = dict(
        ms=timer.ms(floor, iters=100),
        device_ms=timer.ms(floor, iters=100, spin=True),
        what="one-element in-place add (a PyTorch elementwise kernel)")
    log(f"  launch floor: {json.dumps(shapes['launch_floor'])}")
    return shapes


def phase_sgmv_kernels(device, seed, report):
    """Phase 3c; adds the SGMV entry to ``report``."""
    from deepspeed_tpu_torch.ops.decode_attention import (
        lora_sgmv,
        lora_sgmv_plain,
    )

    gen = torch.Generator(device=device).manual_seed(seed + 2)
    timer = Timer(device)
    log("phase 3c: sgmv vs plain (GPT-2 small's LoRA targets, rank 16, B=8), "
        "the delta form and the epilogue form")
    errs, add_errs = {}, {}
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
            add_errs[(dtype, target)] = check_sgmv_add(tag, x, a_pool,
                                                       b_pool, ids, out)
    log("phase 3c: sgmv timing (bf16), both forms, B = 8 and B = 64")
    shapes = time_sgmv(device, gen, timer)
    host = sgmv_host_costs(device, gen)
    log(f"  host time per call: {json.dumps(host)}")
    # the main path's launch: the epilogue form at the widest target, B = 8
    head, delta = shapes["add inter_w B=8"], shapes["delta inter_w B=8"]
    report["sgmv"] = dict(
        name="sgmv", route="cuda", source=SGMV_SOURCE, replaces=SGMV_TPU,
        tpu_kernel=SGMV_TPU,
        shape="inter_w 768->3072, rank 16, B=8, pool rows 5, bf16; the "
              "epilogue form (y + (scale * delta).to(bf16)), apply_lora's "
              "one launch",
        max_abs_err=max(add_errs[(torch.bfloat16, t)] for t in LORA_SHAPES),
        max_abs_err_f32=max(add_errs[(torch.float32, t)]
                            for t in LORA_SHAPES),
        ms=head["ms"], plain_ms=head["plain_ms"],
        library_ms=None, library=None,
        bound_ms=head["bound_ms"], bound_by=head["bound_by"],
        bound_bytes=head["bound_bytes"], bound_flops=head["bound_flops"],
        device_ms=head["device_ms"], device_ms_kind="CUDA events around "
        "one call queued behind a device spin: the kernel alone, without "
        "the host wrapper and launch that ms includes",
        host_us_per_call=host,
        launch_floor=shapes.pop("launch_floor"),
        delta_form=dict(
            delta, max_abs_err=max(errs[(torch.bfloat16, t)]
                                   for t in LORA_SHAPES),
            max_abs_err_f32=max(errs[(torch.float32, t)]
                                for t in LORA_SHAPES)),
        by_shape=shapes,
    )
    return report


def sgmv_host_costs(device, gen, calls=200):
    """Host wall time per call, in microseconds (median of 5 rounds of
    ``calls`` calls), of the SGMV wrappers (each form), of apply_lora's
    fused decode path around them (B=8) and of its gathered path at the
    prefill shape (1 x 1024 tokens), with the kernel launches one fused
    apply_lora call makes (from torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.ops.transformer import apply_lora

    din, dout = LORA_SHAPES["inter_w"]
    x, a_pool, b_pool, ids = sgmv_case(device, gen, torch.bfloat16, din,
                                       dout, 8)
    lora = ({"inter_w": (a_pool, b_pool)}, ids, SGMV_SCALE, True)
    x3 = x[:, None, :]
    y3 = torch.zeros(8, 1, dout, dtype=torch.bfloat16, device=device)
    xp = torch.randn(1, 1024, din, device=device,
                     generator=gen).to(torch.bfloat16)
    yp = torch.zeros(1, 1024, dout, dtype=torch.bfloat16, device=device)
    lora_p = ({"inter_w": (a_pool, b_pool)}, ids[1:2], SGMV_SCALE, True)
    fused = lambda: apply_lora(None, None, lora, "inter_w", x3, y3)
    cases = {f"lora_sgmv {form}": fn
             for form, fn in sgmv_forms(x, a_pool, b_pool, ids).items()}
    cases["apply_lora_fused_decode"] = fused
    cases["apply_lora_gathered_prefill"] = lambda: apply_lora(
        None, None, lora_p, "inter_w", xp, yp)
    out = {name: host_us_per_call(fn, calls) for name, fn in cases.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fused()
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0)
    out["apply_lora_fused_decode_kernel_launches"] = kernels / 10
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
# the engine's and the telemetry profiler window's record_function ranges
ANNOTATIONS = ("window_fwd_bwd", "window_optimizer_update", "train_window#")


def device_breakdown(prof, wall_ms):
    """Device time by kernel in a torch.profiler window, the same summed
    over the port's kernels, cuBLAS's GEMMs and everything else, and the
    device's idle share of the window's wall time (the profiler's own
    host overhead inflates that wall time)."""
    from torch.autograd import DeviceType

    # device-side kernel events only (the host ops' rows repeat the time
    # of the kernels they launched, and a record_function range, such as
    # the engine's window_fwd_bwd, has a device row spanning its kernels)
    device = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
         and not getattr(e, "is_user_annotation", False)
         and not e.key.startswith(ANNOTATIONS)),
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
    """``n`` train_batch windows; their mean losses and wall seconds, and
    the LAMB device tables each built (uploads to the card)."""
    from deepspeed_tpu_torch.ops.fused_lamb import lamb_phase1

    losses, secs, builds = [], [], []
    for _ in range(n):
        before = lamb_phase1.table_builds
        torch.cuda.synchronize()
        t0 = time.monotonic()
        loss = float(engine.train_batch(iter(micro)))
        torch.cuda.synchronize()
        secs.append(time.monotonic() - t0)
        losses.append(loss)
        builds.append(lamb_phase1.table_builds - before)
    return losses, secs, builds


def check_launches(path, got, micro_steps, lamb_steps=0, layers=N_LAYER):
    want = {name: layers * micro_steps for name in TRAIN_KERNELS}
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
    losses, secs, builds = run_windows(engine, micro, windows)
    launches = read_launches()
    log(f"  losses {losses}; LAMB table builds per window {builds}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{optimizer}: a window's loss is not finite")
    skips_ok = engine.loss_scale_state.dynamic
    if (engine.global_steps + engine.skipped_steps != windows
            or engine.global_steps < 1
            or (engine.skipped_steps and not skips_ok)):
        fail(f"{optimizer}: {engine.skipped_steps} skipped steps, "
             f"{engine.global_steps} taken of {windows}")
    return engine, micro, launches, losses, secs, builds


def grads_kernels_vs_plain(seed, cfg=None, dtype=torch.float32):
    """One micro-step of GPT-2 small (or ``cfg``) at dropout 0, its
    parameters in ``dtype``: the gradients through the kernels against the
    gradients through the plain versions of the three attention kernels on
    the card. float32: the worst max|diff| / max|plain| over the
    parameters within TOL. Reduced precision: each parameter's gradient
    within check_close's scaled tolerance of the plain one's (atol TOL x
    max|plain|, rtol TOL), and both paths' worst max|diff| / max|ref|
    against a float32 reference of the same weights (plain versions)
    reported beside it, since both round the whole model. Returns the
    launches of the kernel run and the worst max|diff| / max|plain|."""
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel
    from deepspeed_tpu_torch.ops import attention as A

    cfg = cfg or GPT2Config.small(dropout=0.0)
    model = GPT2LMHeadModel(cfg, device="cuda", dtype=dtype, seed=seed)
    ids = train_batches(seed, model.config.vocab_size)[0][0]

    def grads(m, plain=False):
        kernels = (A.flash_fwd, A.flash_bwd_dq, A.flash_bwd_dkv)
        if plain:
            A.flash_fwd, A.flash_bwd_dq, A.flash_bwd_dkv = (
                plain_flash_fwd, A.flash_bwd_dq_plain,
                A.flash_bwd_dkv_plain)
        try:
            loss = m(ids, ids, train=True)
            return ([g.float() for g in torch.autograd.grad(
                loss, list(m.parameters()))], float(loss.detach()))
        finally:
            A.flash_fwd, A.flash_bwd_dq, A.flash_bwd_dkv = kernels

    def worst(a, b):
        return max(float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
                   for x, y in zip(a, b))

    zero_launches()
    got, loss_k = grads(model)
    torch.cuda.synchronize()
    launches = read_launches()
    want, loss_p = grads(model, plain=True)
    err = worst(got, want)
    tol = TOL[dtype]
    log(f"  {str(dtype)[6:]}: loss kernels {loss_k} plain {loss_p}; "
        f"gradients max|diff| / max|plain| {err:.3e} (tol {tol:g})")
    if dtype == torch.float32:
        if err > tol:
            fail("float32 gradients through the kernels disagree with the "
                 "plain versions'")
        return launches, err
    for (name, _), g, w in zip(model.named_parameters(), got, want):
        atol = tol * float(w.abs().max())
        if not torch.allclose(g, w, atol=atol, rtol=tol):
            fail(f"{dtype} gradient of {name} through the kernels disagrees "
                 f"with the plain versions' (max|diff| "
                 f"{float((g - w).abs().max()):.3e}, atol {atol:.3e})")
    ref_model = GPT2LMHeadModel(cfg, device="cuda", seed=seed)
    with torch.no_grad():
        for r, p in zip(ref_model.parameters(), model.parameters()):
            r.copy_(p.float())
    ref, _ = grads(ref_model, plain=True)
    log(f"  against float32 gradients of the same weights: kernels "
        f"{worst(got, ref):.3e}, plain {worst(want, ref):.3e}")
    del ref_model
    return launches, err


def phase_train(seed, card):
    from torch.profiler import ProfilerActivity, profile

    log("phase 5: GPT-2 small, Adam, bf16, dropout 0.1, 8 windows")
    torch.cuda.reset_peak_memory_stats()
    engine, micro, adam, losses, secs, _ = train_gpt2(seed, "Adam", 1e-4, 8)
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
    engine, _, lamb, lamb_losses, lamb_secs, builds = train_gpt2(
        seed, "FusedLamb", 1e-3, 3)
    check_launches("FusedLamb", lamb, engine.micro_steps, engine.global_steps)
    # the first step builds the device tables; later steps find the same
    # tensors (the engine keeps its cast gradient buffer) and upload none
    if builds[0] < 1 or any(builds[1:]):
        fail(f"FusedLamb: LAMB device tables built {builds} per window, want "
             "some in the first and none after")
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
    engine, _, half, half_losses, _, _ = train_gpt2(seed, "Adam", 1e-4, 3,
                                                    fp16)
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
        "fusedlamb_window_s": lamb_secs,
        "fusedlamb_table_builds_per_window": builds,
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
    losses, secs, _ = run_windows(engine, micro, 4)
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


def count_kernels(prof):
    """Kernel launches in a torch.profiler window (device kernels; the
    host-to-device copies and memsets are not counted)."""
    from torch.autograd import DeviceType

    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.key.startswith(("Memcpy", "Memset")))


def decode_step_kernels(engine, prompts, names, steps=4):
    """Kernel launches one decode step makes: every request admitted and
    prefilled by a first scheduler step, then torch.profiler over
    ``steps`` steps that only decode; the requests then run out."""
    from torch.profiler import ProfilerActivity, profile

    for p, n in zip(prompts, names):
        engine.submit(p, max_new_tokens=steps + 4, adapter=n)
    engine.scheduler.step()
    torch.cuda.synchronize()
    if len(engine.scheduler.active_slots) != len(prompts):
        fail("decode_step_kernels: not every request was admitted")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.scheduler.step()
        torch.cuda.synchronize()
    engine.scheduler.run_until_idle()
    return count_kernels(prof) / steps


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

    log("phase 6: kernel launches per decode step, with and without "
        "adapters")
    step_kernels = {}
    for tag, ads, req_names in (("adapters", adapters, names),
                                ("no_adapters", None, [None] * 8)):
        eng = adapter_engine(model, base, "bf16", True, ads)
        step_kernels[tag] = decode_step_kernels(eng, prompts, req_names)
        eng.close()
    lora_kernels = step_kernels["adapters"] - step_kernels["no_adapters"]
    log(f"  kernel launches per decode step: {step_kernels['adapters']} "
        f"with adapters, {step_kernels['no_adapters']} without: "
        f"{lora_kernels} for LoRA (SGMV with its epilogue: 48 of them)")

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
        "kernel_launches_per_decode_step": step_kernels["adapters"],
        "no_adapters_kernel_launches_per_decode_step":
            step_kernels["no_adapters"],
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


# ---------------------------------------------------------------------------
# phase 7: head dims other than 64 and 128
# ---------------------------------------------------------------------------
HD_FLASH = (32, 48, 96)       # 768 over 24, 16 and 8 heads
HD_WIDE = (192, 256)          # the D = 256 kernels (192 zero-padded)
HD_DECODE = (16, 32, 48, 80, 96, 112, 128)
HD_TAIL = (8, 12, 40, 72)     # rows that are not whole 16-byte chunks
HD32_LAYERS = 2               # the head-dim GPT-2s of phase 7, cut in depth


def hd_config(n_head, **kw):
    """GPT-2 small's widths (768, seq 1024, vocab 50257) over ``n_head``
    heads (head dim 768 / n_head); depth cut to HD32_LAYERS."""
    from deepspeed_tpu_torch import GPT2Config

    return GPT2Config.small(n_head=n_head, n_layer=HD32_LAYERS, **kw)


def check_flash_head_dims(device, gen, timer):
    """The flash forward and backward at d = 32, 48 and 96 (zero-padded to
    the kernels' 64 or 128) against their plain versions at GPT-2 small's
    width (768 = H x d), B=4, S=1024, causal, with and without a padding
    mask and dropout, float32 and bfloat16; then the bf16 times (dropout
    0.1) beside the bound of the UNPADDED function. Returns {d: entry}."""
    from deepspeed_tpu_torch.ops import attention as A

    mask = train_mask(device)[:4]
    out = {}
    for d in HD_FLASH:
        h = 768 // d
        base = [torch.randn(4, h, 1024, d, device=device, generator=gen)
                for _ in range(4)]
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, dout = (t.to(dtype) for t in base)
            for kv_mask, rate in ((None, 0.0), (mask, DROPOUT)):
                tag = (f"d={d} {str(dtype)[6:]} "
                       f"{'mask+dropout' if rate else 'causal'}")
                args = (q, k, v, kv_mask, True, None, rate, 77)
                o, lse = A.flash_fwd(*args)
                torch.cuda.synchronize()
                ref, ref_lse = A.flash_fwd_plain(*args)
                if o.shape != q.shape:
                    fail(f"flash_fwd {tag}: output {tuple(o.shape)}")
                e = check_close(f"flash_fwd {tag}", o, ref, dtype)
                delta = (dout.float() * ref.float()).sum(dim=-1)
                bargs = (q, k, v, kv_mask, dout, ref_lse, delta, True, None,
                         rate, 77)
                got = (A.flash_bwd_dq(*bargs), *A.flash_bwd_dkv(*bargs))
                torch.cuda.synchronize()
                want = (A.flash_bwd_dq_plain(*bargs),
                        *A.flash_bwd_dkv_plain(*bargs))
                for name, g, w in zip(("dq", "dk", "dv"), got, want):
                    e = max(e, check_close(f"flash_bwd {name} {tag}", g, w,
                                           dtype, scaled=True))
                errs[dtype] = max(errs.get(dtype, 0.0), e)
                del o, lse, ref, ref_lse, got, want
        q, k, v, dout = (t.to(torch.bfloat16) for t in base)
        o, lse = A.flash_fwd(q, k, v, None, True, None, DROPOUT, 7)
        delta = (dout.float() * o.float()).sum(dim=-1)
        entry = dict(shape=f"B=4 H={h} S=1024 D={d} causal dropout 0.1 bf16",
                     max_abs_err=errs[torch.bfloat16],
                     max_abs_err_f32=errs[torch.float32])
        for name, fn, args, which in (
            ("flash_fwd", A.flash_fwd, (q, k, v, None, True, None, DROPOUT,
                                        7), "fwd"),
            ("flash_bwd_dq", A.flash_bwd_dq, (q, k, v, None, dout, lse, delta,
                                              True, None, DROPOUT, 7), "dq"),
            ("flash_bwd_dkv", A.flash_bwd_dkv, (q, k, v, None, dout, lse,
                                                delta, True, None, DROPOUT,
                                                7), "dkv"),
        ):
            nbytes, flops = flash_work(q, None, True, which)
            b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
            call = lambda: fn(*args)
            entry[name] = dict(ms=timer.ms(call),
                               device_ms=timer.ms(call, spin=True),
                               bound_ms=b_ms, bound_by=b_by)
        log(f"  flash d={d}: {json.dumps(entry)}")
        out[d] = entry
        del base, q, k, v, dout, o, lse, delta
    return out


# B, H, S, D of the flash timings at each compiled head dim
FLASH_SHAPES = {"d64": TRAIN_SHAPE,          # rows 1-3
                "d128": (8, 6, 1024, 128),   # rows 1m-3m
                "d256": (8, 4, 1024, 256)}   # rows 1w-3w


def time_flash(timer, q, k, v, dout, shape):
    """The three flash kernels' bf16 times at ``q``'s shape (causal,
    dropout 0): ``ms`` and ``device_ms`` (Timer both ways), the plain
    version's, SDPA's (forward; backward with dQ, dK and dV together) and
    the bound of the function at q's head dim (the unpadded one where the
    wrappers pad). Returns {kernel: entry}."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import attention as A

    o, lse = A.flash_fwd(q, k, v, None, True)
    delta = (dout.float() * o.float()).sum(dim=-1)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    sdpa = {
        "fwd": lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True),
        "bwd": lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), dout,
                                           retain_graph=True),
    }
    lib = {key: (timer.ms(fn), timer.ms(fn, spin=True))
           for key, fn in sdpa.items()}
    fargs = (q, k, v, None, True)
    bargs = (q, k, v, None, dout, lse, delta, True)
    out = {}
    for name, fn, plain, args, which, lib_key in (
        ("flash_fwd", A.flash_fwd, A.flash_fwd_plain, fargs, "fwd", "fwd"),
        ("flash_bwd_dq", A.flash_bwd_dq, A.flash_bwd_dq_plain, bargs, "dq",
         "bwd"),
        ("flash_bwd_dkv", A.flash_bwd_dkv, A.flash_bwd_dkv_plain, bargs,
         "dkv", "bwd"),
    ):
        nbytes, flops = flash_work(q, None, True, which)
        b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
        call = lambda: fn(*args)
        out[name] = dict(
            shape=shape,
            ms=timer.ms(call, iters=10), device_ms=timer.ms(
                call, iters=10, spin=True, spin_cycles=20_000_000),
            plain_ms=timer.ms(lambda: plain(*args), iters=3, warmup=1),
            library_ms=lib[lib_key][0],
            library_device_ms=lib[lib_key][1],
            library=("scaled_dot_product_attention forward"
                     if lib_key == "fwd" else
                     "scaled_dot_product_attention backward (dQ, dK "
                     "and dV together)"),
            bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
            bound_flops=flops)
    del o, lse, delta, qg, kg, vg, sdpa_out
    return out


def check_flash_wide(device, gen, timer):
    """The D = 256 kernels (bf16/fp16 on the tensor cores, float32 on the
    FMA units): the flash forward and backward at
    d = 192 (zero-padded to 256) and 256 against their plain versions at
    B*H = 32 (B=8, H=4), S=1024, causal, with and without a padding mask
    and dropout, float32, bfloat16 and float16; then the bf16 times
    (causal, dropout 0) beside the bound of the unpadded function, the
    plain version's time and SDPA's. Returns {d: {kernel: entry}}."""
    from deepspeed_tpu_torch.ops import attention as A

    mask = train_mask(device)
    out = {}
    for d in HD_WIDE:
        base = [torch.randn(8, 4, 1024, d, device=device, generator=gen)
                for _ in range(4)]
        errs = {}
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            q, k, v, dout = (t.to(dtype) for t in base)
            for kv_mask, rate in ((None, 0.0), (mask, DROPOUT)):
                tag = (f"d={d} {str(dtype)[6:]} "
                       f"{'mask+dropout' if rate else 'causal'}")
                args = (q, k, v, kv_mask, True, None, rate, 77)
                o, lse = A.flash_fwd(*args)
                torch.cuda.synchronize()
                ref, ref_lse = A.flash_fwd_plain(*args)
                if o.shape != q.shape:
                    fail(f"flash_fwd {tag}: output {tuple(o.shape)}")
                e = {"flash_fwd": check_close(f"flash_fwd {tag}", o, ref,
                                              dtype)}
                delta = (dout.float() * ref.float()).sum(dim=-1)
                bargs = (q, k, v, kv_mask, dout, ref_lse, delta, True, None,
                         rate, 77)
                got = (A.flash_bwd_dq(*bargs), *A.flash_bwd_dkv(*bargs))
                torch.cuda.synchronize()
                want = (A.flash_bwd_dq_plain(*bargs),
                        *A.flash_bwd_dkv_plain(*bargs))
                for name, g, w in zip(("flash_bwd_dq", "flash_bwd_dkv",
                                       "flash_bwd_dkv"), got, want):
                    err = check_close(f"{name} {tag}", g, w, dtype,
                                      scaled=True)
                    e[name] = max(e.get(name, 0.0), err)
                for name, err in e.items():
                    key = (name, dtype)
                    errs[key] = max(errs.get(key, 0.0), err)
                del o, lse, ref, ref_lse, got, want
        q, k, v, dout = (t.to(torch.bfloat16) for t in base)
        out[d] = time_flash(
            timer, q, k, v, dout,
            f"B=8 H=4 S=1024 D={d} (kernel D=256) causal bf16")
        for name, entry in out[d].items():
            entry.update(max_abs_err=errs[(name, torch.bfloat16)],
                         max_abs_err_f32=errs[(name, torch.float32)],
                         max_abs_err_f16=errs[(name, torch.float16)])
            log(f"  {name} d={d}: {json.dumps(entry)}")
            before = FMA_BEFORE_MS.get(f"{name} d256")
            if before is not None:
                log(f"  {name} d={d}: ms {entry['ms']:.4f}, device_ms "
                    f"{entry['device_ms']:.4f}; before_ms {before} at d=256 "
                    "(the FMA kernel)")
        del base, q, k, v, dout
        torch.cuda.empty_cache()
    return out


def check_wide_routes(device):
    """Which kernel each D = 256 call launches, by torch.profiler's kernel
    names: the tensor-core forward, dQ and dK/dV in bfloat16 and float16,
    the FMA kernels in float32 (ops/attention.py:flash_route).
    Returns {"<dtype> <kernel>": kernel name}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.ops import attention as A

    out = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        q, k, v, dout = (torch.randn(1, 2, 256, 256, device=device)
                         .to(dtype) for _ in range(4))
        rows = torch.zeros(1, 2, 256, device=device)
        bargs = (q, k, v, None, dout, rows, rows, True)
        for kernel, fn, args in (("fwd", A.flash_fwd, (q, k, v, None, True)),
                                 ("dq", A.flash_bwd_dq, bargs),
                                 ("dkv", A.flash_bwd_dkv, bargs)):
            fragment = {"fwd": "flash_fwd_kernel", "dq": "flash_bwd_dq_kernel",
                        "dkv": "flash_bwd_dkv_kernel"}[kernel]
            fn(*args)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(Timer.SPIN_CYCLES)  # let the trace start
                for _ in range(3):
                    fn(*args)
                torch.cuda.synchronize()
            kernels = [e.key for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA]
            names = [n for n in kernels if fragment in n]
            route = A.flash_route(dtype, 256, kernel)
            on_tc = [n for n in names if fragment + "_tc" in n]
            if len(names) != 1 or bool(on_tc) != (route == "wgmma"):
                fail(f"D = 256 {dtype} {kernel}: launched {names} (every "
                     f"kernel of the window: {kernels}), want the {route} "
                     "kernel")
            out[f"{str(dtype)[6:]} {kernel}"] = names[0]
            log(f"  D=256 {str(dtype)[6:]} {kernel} ({route}): {names[0]}")
    return out


def check_flash_d128(device, gen, timer):
    """The tensor-core kernels at D = 128 (the forward and dK/dV in
    256-thread blocks, dQ in the 384-thread one of D = 64): bf16, B=8
    H=6 S=1024 D=128 causal (GPT-2 small's width over 6 heads, the hd-128
    model's attention at micro-batch 8), each kernel once against its
    plain version, then the times of time_flash. Returns {kernel:
    entry}."""
    from deepspeed_tpu_torch.ops import attention as A

    b, h, s, d = FLASH_SHAPES["d128"]
    q, k, v, dout = (torch.randn(b, h, s, d, device=device,
                                 generator=gen).to(torch.bfloat16)
                     for _ in range(4))
    o, lse = A.flash_fwd(q, k, v, None, True)
    torch.cuda.synchronize()
    ref, ref_lse = A.flash_fwd_plain(q, k, v, None, True)
    errs = {"flash_fwd": check_close("flash_fwd d=128 bf16 causal", o, ref,
                                     torch.bfloat16)}
    delta = (dout.float() * ref.float()).sum(dim=-1)
    bargs = (q, k, v, None, dout, ref_lse, delta, True)
    got = (A.flash_bwd_dq(*bargs), *A.flash_bwd_dkv(*bargs))
    torch.cuda.synchronize()
    want = (A.flash_bwd_dq_plain(*bargs), *A.flash_bwd_dkv_plain(*bargs))
    for name, g, w in zip(("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dkv"),
                          got, want):
        errs[name] = max(errs.get(name, 0.0), check_close(
            f"{name} d=128 bf16 causal", g, w, torch.bfloat16, scaled=True))
    del o, lse, ref, ref_lse, delta, got, want
    out = time_flash(timer, q, k, v, dout,
                     f"B={b} H={h} S={s} D={d} causal bf16")
    for name, entry in out.items():
        entry["max_abs_err"] = errs[name]
        log(f"  {name} d=128: {json.dumps(entry)}")
        before = FMA_BEFORE_MS.get(f"{name} d128")
        if before is not None:
            log(f"  {name} d=128: ms {entry['ms']:.4f}, device_ms "
                f"{entry['device_ms']:.4f}; before_ms {before} "
                f"({D128_BEFORE_FORM[name]})")
    del q, k, v, dout
    torch.cuda.empty_cache()
    return out


def check_decode_head_dims(device, gen, timer):
    """Paged decode at hd 16, 32, 48, 80, 96, 112 and 128 (the hd-128
    model's serving width), and at the tails 8, 12, 40 and 72 (rows that
    are not whole 16-byte chunks), against its plain version at the
    bench shape's layout (8 slots x 12 heads, 16-token pages, 64 pages a
    slot, a dead slot, a NULL page mid-table), float32 and bfloat16, 10 calls bitwise equal; then its
    times in both dtypes, and the bf16 plain version's. Returns
    {hd: entry}."""
    from deepspeed_tpu_torch.ops.decode_attention import (
        paged_flash_decode,
        paged_flash_decode_plain,
    )

    slots, heads, bs, mb = 8, 12, 16, 64
    positions = torch.tensor([15, 100, 1023, 0, 500, 257, 31, 700],
                             dtype=torch.int32, device=device)
    out = {}
    for hd in HD_DECODE + HD_TAIL:
        errs, calls = {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            pages = slots * mb + 1
            q = torch.randn(slots, heads, hd, device=device,
                            generator=gen).to(dtype)
            kp, vp = (torch.randn(pages, bs, heads, hd, device=device,
                                  generator=gen).to(dtype) for _ in range(2))
            perm = torch.randperm(pages - 1, device=device, generator=gen) + 1
            tables = perm.reshape(slots, mb).to(torch.int32)
            tables[3] = 0
            tables[5, 3] = 0
            tables = tables.contiguous()
            o = paged_flash_decode(q, kp, vp, tables, positions)
            torch.cuda.synchronize()
            tag = f"paged_decode hd={hd} {str(dtype)[6:]}"
            errs[dtype] = check_close(
                tag, o, paged_flash_decode_plain(q, kp, vp, tables,
                                                 positions), dtype)
            if not bool((o[3] == 0).all()):
                fail(f"{tag}: the dead slot is not exact zeros")
            for _ in range(10):
                if not torch.equal(
                        paged_flash_decode(q, kp, vp, tables, positions), o):
                    fail(f"{tag}: two calls on the same inputs differ")
            calls[dtype] = (q, kp, vp, tables)
        q, kp, vp, tables = calls[torch.bfloat16]
        fn = lambda: paged_flash_decode(q, kp, vp, tables, positions)
        nbytes, flops = decode_work(q, tables, positions, bs)
        b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
        q32, kp32, vp32, t32 = calls[torch.float32]
        fn32 = lambda: paged_flash_decode(q32, kp32, vp32, t32, positions)
        out[hd] = dict(
            shape=f"8 slots x 12 heads x hd {hd}, 16-token pages, bf16",
            max_abs_err=errs[torch.bfloat16],
            max_abs_err_f32=errs[torch.float32], ms=timer.ms(fn),
            device_ms=timer.ms(fn, spin=True),
            device_ms_f32=timer.ms(fn32, spin=True),
            plain_ms=timer.ms(lambda: paged_flash_decode_plain(
                q, kp, vp, tables, positions), iters=5, warmup=1),
            bound_ms=b_ms, bound_by=b_by,
            bound_ms_f32=bound(*decode_work(q32, t32, positions, bs),
                               torch.float32)[0])
        log(f"  paged_decode hd={hd}: {json.dumps(out[hd])}")
    return out


def hd_train(seed, n_head, bf16_grads=False):
    """One bf16 training micro-step (dropout 0.1) of the head-dim GPT-2
    over ``n_head`` heads: each attention kernel launched once a layer;
    then float32 gradients through the kernels against the plain
    versions' (the FMA route), and with ``bf16_grads`` bfloat16 ones too
    (the tensor-core route). Returns (launches, loss, {dtype: gradient
    error})."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2LMHeadModel

    cfg = hd_config(n_head, dropout=DROPOUT)
    model = GPT2LMHeadModel(cfg, device="cuda", seed=seed)
    config = dict(train_config("Adam", 1e-4, BF16), train_batch_size=8,
                  gradient_accumulation_steps=1)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model,
                                                     config_params=config)
    ids = train_batches(seed, cfg.vocab_size)[0][0]
    zero_launches()
    loss = float(engine.train_batch(iter([(ids, ids)])))
    torch.cuda.synchronize()
    launches = read_launches()
    want = {n: HD32_LAYERS for n in TRAIN_KERNELS}
    got = {n: launches[n] for n in TRAIN_KERNELS}
    log(f"  loss {loss}, launches {launches}")
    if not math.isfinite(loss) or got != want or engine.global_steps != 1:
        fail(f"hd {768 // n_head} training: loss {loss}, launches {got} "
             f"(want {want}), {engine.global_steps} steps")
    del engine
    grad_err = {}
    for dtype in (torch.float32, torch.bfloat16)[:1 + bf16_grads]:
        grad_launches, grad_err[str(dtype)[6:]] = grads_kernels_vs_plain(
            seed, hd_config(n_head, dropout=0.0), dtype)
        if any(grad_launches[n] != HD32_LAYERS for n in TRAIN_KERNELS):
            fail(f"hd {768 // n_head} {dtype} gradients: launches "
                 f"{grad_launches}")
    return launches, loss, grad_err


def hd_serve(seed, n_head, fused):
    """The head-dim GPT-2 over ``n_head`` heads served in bf16 (a 300-token
    cold prefill through the flash forward, a 40-token prompt; with
    ``fused``, decode through paged decode), then in float32: with
    ``fused``, fused == unfused greedy tokens; the first token the full
    forward's argmax. Last, the flash forward on bf16 tensors at the two
    prompts' shapes, causal, against its plain version. Returns
    (launches, stats)."""
    from deepspeed_tpu_torch import GPT2LMHeadModel

    hd = 768 // n_head
    cfg = hd_config(n_head)
    model = GPT2LMHeadModel(cfg, device="cuda", seed=seed)
    g = torch.Generator().manual_seed(seed + 5)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (300, 40)]
    zero_launches()
    out_bf16, st = serve(model, "bf16", fused, prompts[:1], prompts[1])
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"  launches {launches} stats {json.dumps(st)}")
    want_decode = HD32_LAYERS * st["decode_steps"] if fused else 0
    if (launches["flash_fwd"] < HD32_LAYERS
            or launches["paged_decode"] != want_decode
            or st["decode_steps"] < 1):
        fail(f"hd {hd} serving: launches {launches} for "
             f"{st['decode_steps']} decode steps")
    if not all(len(o) == 32 and all(0 <= t < cfg.vocab_size for t in o)
               for o in out_bf16):
        fail(f"hd {hd} serving: wrong token counts or tokens outside the "
             "vocab")
    out_f, _ = serve(model, "fp32", fused, prompts[:1], prompts[1])
    if fused:
        out_u, _ = serve(model, "fp32", False, prompts[:1], prompts[1])
        if out_f != out_u:
            fail(f"hd {hd} serving: float32 fused and unfused greedy tokens "
                 "differ")
    ref = model(torch.tensor([prompts[0]], device="cuda"))
    if out_f[0][0] != int(ref[0, -1, :cfg.vocab_size].argmax()):
        fail(f"hd {hd} serving: the first token is not the full forward's "
             "argmax")
    log(f"  float32{' fused == unfused;' if fused else ''} first token == "
        "full-forward argmax")
    # the flash forward at the shapes the bf16 prefills gave it, against
    # its plain version (outside the counted run)
    from deepspeed_tpu_torch.ops import attention as A

    gq = torch.Generator(device="cuda").manual_seed(seed + 6)
    err = 0.0
    for n in (300, 40):
        q, k, v = (torch.randn(1, n_head, n, hd, device="cuda", generator=gq)
                   .to(torch.bfloat16) for _ in range(3))
        o, _ = A.flash_fwd(q, k, v, None, True)
        torch.cuda.synchronize()
        err = max(err, check_close(
            f"flash_fwd hd={hd} B=1 H={n_head} S={n} bf16 causal", o,
            A.flash_fwd_plain(q, k, v, None, True)[0], torch.bfloat16))
    st["prefill_flash_fwd_max_abs_err"] = err
    return launches, st


def phase_head_dims(seed, card):
    """Phase 7: the kernels at head dims other than 64, then GPT-2s of
    GPT-2 small's widths cut to HD32_LAYERS layers: 24 heads (head dim
    32), 4 heads (head dim 192, the D = 256 kernels) and 6 heads (head dim
    128, the D = 128 kernels unpadded) through one training micro-step
    (the flash forward and backward launched once a layer; float32
    gradients through the kernels equal to those through the plain
    versions, and at head dims 128 and 192 bfloat16 ones, the tensor-core
    route) and serving (a cold prefill of 300 tokens through the flash
    forward; fused decode at head dims 32 and 128, the gathered decode at
    192, which the paged decode kernel does not take); and 96 heads (head
    dim 8, the decode kernel's tail path) served with fused decode, float32
    fused == unfused. Returns (launches by path, stats)."""
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(seed + 4)
    timer = Timer(device)
    log("phase 7: flash forward and backward at d = 32, 48, 96 vs plain")
    flash = check_flash_head_dims(device, gen, timer)
    log("phase 7: the D = 256 kernels at d = 192 and 256 vs plain")
    wide = check_flash_wide(device, gen, timer)
    log("phase 7: the tensor-core kernels at D = 128 (B=8 H=6 S=1024)")
    d128 = check_flash_d128(device, gen, timer)
    log("phase 7: paged decode at hd = 16, 32, 48, 80, 96, 112 and the "
        "tails 8, 12, 40, 72 vs plain")
    decode = check_decode_head_dims(device, gen, timer)

    launches, stats = {}, {}
    for n_head, train, fused in ((24, True, True), (4, True, False),
                                 (6, True, True), (96, False, True)):
        hd = 768 // n_head
        if train:
            log(f"phase 7: GPT-2 768 / {n_head} heads (hd {hd}, "
                f"{HD32_LAYERS} layers), one training micro-step, bf16, "
                "dropout 0.1")
            launches[f"hd{hd}_train"], loss, err = hd_train(
                seed, n_head, bf16_grads=hd >= 128)
            stats[f"hd{hd}_loss"] = loss
            for dt, e in err.items():
                stats[f"hd{hd}_{dt}_grad_max_rel_err"] = e
        log(f"phase 7: the same model served, bf16, fused decode "
            f"{'on' if fused else 'off'}")
        launches[f"hd{hd}_serve"], st = hd_serve(seed, n_head, fused)
        stats[f"hd{hd}_decode_steps"] = st["decode_steps"]
        stats[f"hd{hd}_cold_prefills"] = st["cold_prefills"]
        stats[f"hd{hd}_prefill_flash_fwd_max_abs_err"] = st[
            "prefill_flash_fwd_max_abs_err"]
    return launches, dict(stats, flash=flash, flash_wide=wide,
                          flash_d128=d128,
                          paged_decode=decode)


# ---------------------------------------------------------------------------
# phase 8: the telemetry core on the training and serving paths
# ---------------------------------------------------------------------------
TEL_WINDOWS = 8       # training windows a run
TEL_INTERVAL = 4      # telemetry.interval: exports after windows 4 and 8
TEL_PROFILE = (1, 2)  # telemetry.profile: windows 1 and 2, no export in them
TEL_STEADY = slice(3, TEL_WINDOWS)  # the windows the step median reads


def telemetry_block(out_dir, profile=True, timeout=120.0, poll=1.0):
    """The full telemetry block: jsonl and Prometheus exporters every
    TEL_INTERVAL windows, the watchdog, tracing at sample rate 1 (Chrome
    export) and, with ``profile``, the TEL_PROFILE profiler window."""
    block = {"enabled": True, "output_path": out_dir, "job_name": "gpt2",
             "interval": TEL_INTERVAL, "exporters": ["jsonl", "prometheus"],
             "watchdog": {"timeout": timeout, "poll_interval": poll},
             "tracing": {"enabled": True, "sample_rate": 1.0}}
    if profile:
        block["profile"] = {"start_step": TEL_PROFILE[0],
                            "num_steps": TEL_PROFILE[1]}
    return block


def tel_train(seed, out_dir, on, **block_kw):
    """GPT-2 small (full width and depth, seq 1024, bf16, dropout 0.1,
    FusedLamb) trained TEL_WINDOWS windows through initialize(); ``on``
    adds the full telemetry block, ``tensorboard``, ``wall_clock_breakdown``
    and ``memory_breakdown``. Without it, a torch.profiler of this script
    covers the same windows TEL_PROFILE names. Returns the run's record:
    window seconds, losses, launches, the engine's telemetry (closed) and
    the profiler trace's path."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel
    from torch.profiler import ProfilerActivity, profile

    cfg = GPT2Config.small(dropout=DROPOUT)
    micro = train_batches(seed, cfg.vocab_size)
    model = GPT2LMHeadModel(cfg, device="cuda", seed=seed)
    config = dict(train_config("FusedLamb", 1e-3, BF16),
                  steps_per_print=TEL_INTERVAL)
    if on:
        config.update(
            telemetry=telemetry_block(out_dir, **block_kw),
            tensorboard={"enabled": True, "output_path": out_dir,
                         "job_name": "monitor"},
            wall_clock_breakdown=True, memory_breakdown=True)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=config)
    first, last = TEL_PROFILE[0], TEL_PROFILE[0] + TEL_PROFILE[1] - 1
    trace = engine.telemetry.profiler.trace_path if (
        on and engine.telemetry.profiler is not None) else None
    prof = None
    zero_launches()
    secs, losses = [], []
    for w in range(TEL_WINDOWS):
        if not on and w == first:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        losses.append(engine.train_batch(iter(micro)))
        torch.cuda.synchronize()
        secs.append(time.monotonic() - t0)
        if prof is not None and w == last:
            prof.stop()
            trace = str(Path(out_dir) / "baseline_profile.json")
            prof.export_chrome_trace(trace)
            prof = None
    launches = read_launches()
    hbm = torch.cuda.max_memory_allocated()
    stalls = (engine.telemetry.watchdog.stall_count
              if engine.telemetry.watchdog is not None else None)
    n_params = engine._n_params
    timers = sorted(engine.timers.timers)
    engine.close()
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        fail(f"telemetry {'on' if on else 'off'}: a loss is not finite")
    check_launches(f"telemetry {'on' if on else 'off'}", launches,
                   engine.micro_steps, engine.global_steps)
    del engine, model
    torch.cuda.empty_cache()
    steady = sorted(secs[TEL_STEADY])
    return dict(secs=secs, losses=losses, launches=launches, hbm=hbm,
                stalls=stalls, n_params=n_params, timers=timers, trace=trace,
                step_ms=steady[len(steady) // 2] * 1e3)


def trace_events(path):
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def dtoh_copies(path):
    """Device-to-host copies in a torch.profiler Chrome trace."""
    return sum(1 for e in trace_events(path)
               if "Memcpy DtoH" in str(e.get("name", "")))


def kernels_in_ranges(path, fragments, range_name):
    """Which kernels of ``fragments`` the trace shows launched inside a
    ``range_name`` range: a kernel event whose correlation id is that of
    a runtime launch whose host time lies inside the range."""
    events = trace_events(path)
    ranges = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
              if e.get("name") == range_name and e.get("ph") == "X"]
    if not ranges:
        fail(f"profiler trace {path} has no {range_name} range")
    launch_ts = {}  # the runtime's or the driver's launch call
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and \
                "correlation" in e.get("args", {}):
            launch_ts[e["args"]["correlation"]] = e["ts"]
    found = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        frag = next((f for f in fragments if f in e.get("name", "")), None)
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        if frag is None or ts is None:
            continue
        if any(a <= ts <= b for a, b in ranges):
            found[frag] = found.get(frag, 0) + 1
    return found


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def check_training_sinks(out_dir, run):
    """Read back what the telemetry run wrote: metrics.jsonl with every
    name of the ported catalog, metrics.prom, the Chrome span trace, the
    profiler trace (the window ranges, and the port's kernels inside
    them) and the monitor's events. Returns the numbers it read."""
    from deepspeed_tpu_torch.telemetry.manager import ENGINE_METRICS
    from deepspeed_tpu_torch.telemetry.tracing import load_chrome_trace

    job = Path(out_dir) / "gpt2"
    for name in ("metrics.jsonl", "metrics.prom", "trace.json"):
        if not (job / name).is_file():
            fail(f"telemetry: {job / name} was not written")
    records = read_jsonl(job / "metrics.jsonl")
    tags = {r["tag"] for r in records}
    missing = sorted(n for _, n, _ in ENGINE_METRICS if n not in tags)
    if missing:
        fail(f"telemetry: metrics.jsonl lacks {missing}")
    last = {r["tag"]: r for r in records if r["step"] == TEL_WINDOWS}
    steps = sorted({r["step"] for r in records})
    if steps != [TEL_INTERVAL, TEL_WINDOWS]:
        fail(f"telemetry: exports at steps {steps}, want "
             f"{[TEL_INTERVAL, TEL_WINDOWS]}")
    got = {t: last[t]["value"] for t in (
        "train/hbm_peak_bytes", "train/model_tflops", "train/tokens_per_sec",
        "train/loss", "train/global_steps", "train/grad_norm",
        "train/learning_rate", "device/bytes_in_use")}
    if got["train/hbm_peak_bytes"] != run["hbm"]:
        fail(f"telemetry: train/hbm_peak_bytes {got['train/hbm_peak_bytes']}"
             f" != torch.cuda.max_memory_allocated() {run['hbm']}")
    want_tflops = 6.0 * run["n_params"] * got["train/tokens_per_sec"] / 1e12
    if not (got["train/tokens_per_sec"] > 0 and math.isclose(
            got["train/model_tflops"], want_tflops, rel_tol=1e-9)):
        fail(f"telemetry: train/model_tflops {got['train/model_tflops']} is "
             f"not 6 N tokens/s / 1e12 = {want_tflops}")
    if (got["train/global_steps"] != TEL_WINDOWS
            or not math.isclose(got["train/loss"], run["losses"][-1],
                                rel_tol=1e-6)):
        fail(f"telemetry: the last export {got} does not match the run "
             f"(loss {run['losses'][-1]})")
    prom = (job / "metrics.prom").read_text()
    if "# TYPE train_loss gauge" not in prom or "train_hbm_peak_bytes" \
            not in prom:
        fail("telemetry: metrics.prom lacks the train families")
    spans = load_chrome_trace(str(job / "trace.json"))
    windows = [e for e in spans if e["name"] == "train.window"]
    if len(windows) != TEL_WINDOWS:
        fail(f"telemetry: {len(windows)} train.window spans, want "
             f"{TEL_WINDOWS}")
    if not run["trace"] or not Path(run["trace"]).is_file():
        fail(f"telemetry: no profiler trace at {run['trace']}")
    names = {e.get("name") for e in trace_events(run["trace"])}
    for r in ("window_fwd_bwd", "window_optimizer_update",
              *(f"train_window#{w}" for w in range(
                  TEL_PROFILE[0], TEL_PROFILE[0] + TEL_PROFILE[1]))):
        if r not in names:
            fail(f"telemetry: the profiler trace has no {r} range")
    fwd_bwd = kernels_in_ranges(
        run["trace"], ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                       "flash_bwd_dkv_kernel"), "window_fwd_bwd")
    update = kernels_in_ranges(run["trace"], ("lamb_phase1_kernel",),
                               "window_optimizer_update")
    per = N_LAYER * 2 * TEL_PROFILE[1]  # layers x micro-steps x windows
    want = {"flash_fwd_kernel": per, "flash_bwd_dq_kernel": per,
            "flash_bwd_dkv_kernel": per}
    if fwd_bwd != want or update.get("lamb_phase1_kernel") != 6 * \
            TEL_PROFILE[1]:
        fail(f"telemetry: the profiler trace holds {fwd_bwd} inside "
             f"window_fwd_bwd (want {want}) and {update} inside "
             "window_optimizer_update (want 6 a window)")
    monitor = Path(out_dir) / "monitor"
    if (monitor / "events.jsonl").is_file():
        mtags = {(e["tag"], e["step"])
                 for e in read_jsonl(monitor / "events.jsonl")}
        monitor_file = "events.jsonl"
    else:
        # PyTorch's TensorBoard writer (the tensorboard package is
        # installed): read its event files back with that package
        from tensorboard.backend.event_processing.event_accumulator import (
            EventAccumulator,
        )

        tb = sorted(p.name for p in monitor.glob("events.out.tfevents*"))
        if not tb:
            fail(f"telemetry: the monitor wrote nothing under {monitor}")
        acc = EventAccumulator(str(monitor))
        acc.Reload()
        mtags = {(tag, e.step) for tag in acc.Tags()["scalars"]
                 for e in acc.Scalars(tag)}
        monitor_file = tb[0]
    want_m = {(t, s) for t in ("Train/loss", "Train/lr", "Train/loss_scale",
                               "Train/grad_norm")
              for s in range(1, TEL_WINDOWS + 1)}
    if not want_m <= mtags:
        fail(f"telemetry: the monitor's {monitor_file} lacks "
             f"{sorted(want_m - mtags)[:4]}")
    return dict(last_export=got, fwd_bwd_kernels=fwd_bwd,
                update_kernels=update, monitor_file=monitor_file,
                catalog_names=len(ENGINE_METRICS))


def tel_serve(model, prompts, hit, out_dir):
    """The phase 4 requests (4 prompts and a prefix hit, 32 new tokens,
    bf16, fused decode) with telemetry and tracing on (``out_dir``) or
    off (None). Returns (tokens, stats)."""
    import deepspeed_tpu_torch

    config = engine_config("bf16", True)
    if out_dir is not None:
        config["telemetry"] = telemetry_block(out_dir, profile=False)
    engine = deepspeed_tpu_torch.init_inference(model=model, config=config)
    try:
        t0 = time.monotonic()
        out = engine.generate(prompts, max_new_tokens=32)
        out += engine.generate([hit], max_new_tokens=32)
        st = engine_stats(engine, time.monotonic() - t0)
    finally:
        engine.close()
    st["decode_tokens_per_s"] = (st["tokens"] - st["requests"]) / (
        st["decode_ms_sum"] / 1e3)
    return out, st


def check_serving_sinks(out_dir, st):
    """Read back the traced serving run: one sched.request, queue and
    prefill span per request, decode-step spans, and the infer/*
    catalog in metrics.jsonl."""
    from deepspeed_tpu_torch.telemetry.manager import INFERENCE_METRICS
    from deepspeed_tpu_torch.telemetry.tracing import load_chrome_trace

    job = Path(out_dir) / "gpt2"
    for name in ("metrics.jsonl", "metrics.prom", "trace.json"):
        if not (job / name).is_file():
            fail(f"serving telemetry: {job / name} was not written")
    spans = load_chrome_trace(str(job / "trace.json"))
    counts = {}
    for e in spans:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    n = int(st["requests"])
    for name in ("sched.request", "sched.queue", "sched.prefill"):
        if counts.get(name) != n:
            fail(f"serving telemetry: {counts.get(name)} {name} spans for "
                 f"{n} requests")
    if counts.get("sched.decode_step", 0) < st["decode_steps"]:
        fail(f"serving telemetry: {counts.get('sched.decode_step')} decode "
             f"step spans for {st['decode_steps']} decode steps")
    tags = {r["tag"] for r in read_jsonl(job / "metrics.jsonl")}
    missing = sorted(n for _, n, _ in INFERENCE_METRICS if n not in tags)
    if missing:
        fail(f"serving telemetry: metrics.jsonl lacks {missing}")
    return counts


def phase_telemetry(seed, card):
    """Phase 8: the telemetry core at full width and depth. Training:
    GPT-2 small with FusedLamb, TEL_WINDOWS windows, runs in the order
    off, on, on, off (the full telemetry block, tensorboard and the
    breakdowns); the step median over the steady windows, the device-to-
    host copies of the two profiled non-export windows in each run, and
    every sink the telemetry wrote read back. Serving: the phase 4
    requests with tracing (sample rate 1) off, on, on, off; TTFT and
    decode tokens/s, and the traced run's spans and metrics read back.
    Returns (launches by path, stats)."""
    import tempfile

    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    runs, checks, launches = [], None, {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, on in enumerate((False, True, True, False)):
            out_dir = str(Path(tmp) / f"train{i}")
            Path(out_dir).mkdir()
            log(f"phase 8: GPT-2 small, FusedLamb, {TEL_WINDOWS} windows, "
                f"telemetry {'on' if on else 'off'}")
            run = tel_train(seed, out_dir, on)
            run["on"] = on
            run["dtoh_per_window"] = dtoh_copies(run["trace"]) / TEL_PROFILE[1]
            log(f"  step median {run['step_ms']:.3f} ms, DtoH copies a "
                f"non-export window {run['dtoh_per_window']}, losses "
                f"{run['losses']}, timers {run['timers']}, watchdog stalls "
                f"{run['stalls']}")
            if on:
                if run["stalls"] != 0:
                    fail(f"telemetry: the watchdog reported {run['stalls']} "
                         "stalls")
                if run["timers"] != ["backward", "forward", "step",
                                     "train_batch_window"]:
                    fail(f"telemetry: wall_clock_breakdown timers "
                         f"{run['timers']}")
                checks = check_training_sinks(out_dir, run)
                log(f"  sinks read back: {json.dumps(checks)}")
                launches["telemetry_train"] = run["launches"]
            runs.append(run)
        on_dtoh = {r["dtoh_per_window"] for r in runs if r["on"]}
        off_dtoh = {r["dtoh_per_window"] for r in runs if not r["on"]}
        if max(on_dtoh) > min(off_dtoh):
            fail(f"telemetry: a non-export window made {on_dtoh} device-to-"
                 f"host copies with the telemetry on, {off_dtoh} without")

        cfg = GPT2Config.small()
        model = GPT2LMHeadModel(cfg, device="cuda", seed=seed)
        prompts, hit = prompts_for(seed, cfg.vocab_size)
        tel_serve(model, [prompts[0]], prompts[0][:8], None)  # warm-up
        serving, traced = [], None
        for i, on in enumerate((False, True, True, False)):
            out_dir = str(Path(tmp) / f"serve{i}") if on else None
            log(f"phase 8: serving, tracing {'on' if on else 'off'}")
            zero_launches()
            out, st = tel_serve(model, prompts, hit, out_dir)
            torch.cuda.synchronize()
            got = read_launches()
            if (got["paged_decode"] != N_LAYER * st["decode_steps"]
                    or got["flash_fwd"] < N_LAYER * st["cold_prefills"]):
                fail(f"serving telemetry: launches {got} for "
                     f"{st['decode_steps']} decode steps")
            if serving and out != serving[0]["tokens"]:
                fail("serving telemetry: greedy tokens differ with tracing "
                     "on and off")
            log(f"  TTFT mean {st['ttft_ms_mean']:.3f} ms, decode "
                f"{st['decode_tokens_per_s']:.1f} tokens/s over "
                f"{st['decode_steps']} steps on {card}")
            if on and traced is None:
                traced = check_serving_sinks(out_dir, st)
                launches["telemetry_serve"] = got
                log(f"  spans read back: {json.dumps(traced)}")
            serving.append(dict(on=on, tokens=out, ttft_ms=st["ttft_ms_mean"],
                                decode_tokens_per_s=st[
                                    "decode_tokens_per_s"]))
    return launches, {
        "train_order": ["off", "on", "on", "off"],
        "train_step_ms": [r["step_ms"] for r in runs],
        "train_dtoh_per_non_export_window": [r["dtoh_per_window"]
                                             for r in runs],
        "train_window_s": [r["secs"] for r in runs],
        "train_last_export": checks["last_export"],
        "profile_kernels_in_window_fwd_bwd": checks["fwd_bwd_kernels"],
        "profile_kernels_in_window_optimizer_update":
            checks["update_kernels"],
        "monitor_file": checks["monitor_file"],
        "serve_order": ["off", "on", "on", "off"],
        "serve_ttft_ms": [r["ttft_ms"] for r in serving],
        "serve_decode_tokens_per_s": [r["decode_tokens_per_s"]
                                      for r in serving],
        "serve_span_counts": traced,
    }


def cold_build_telemetry(seed, card):
    """``--cold-telemetry``: one telemetry-on training run (no profiler)
    whose first window builds the kernels in an empty build directory,
    with a watchdog timeout of 5 s polled every 0.5 s. The watchdog arms
    at the first completed window, so the build inside it must not read
    as a stall."""
    import shutil
    import tempfile

    from deepspeed_tpu_torch.ops import kernel_lib

    kernel_lib.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    cold = Path(tempfile.mkdtemp(prefix="cold-",
                                 dir=kernel_lib.BUILD_DIR.parent))
    kernel_lib.BUILD_DIR = cold
    try:
        with tempfile.TemporaryDirectory() as tmp:
            run = tel_train(seed, tmp, True, profile=False, timeout=5.0,
                            poll=0.5)
    finally:
        shutil.rmtree(cold)
    log(f"  first window {run['secs'][0]:.1f} s (the build), later windows "
        f"{[round(x, 3) for x in run['secs'][1:]]} s, watchdog stalls "
        f"{run['stalls']} on {card}")
    if run["stalls"] != 0:
        fail(f"cold build: the watchdog reported {run['stalls']} stalls")
    return {"first_window_s": run["secs"][0], "window_s": run["secs"],
            "watchdog_timeout_s": 5.0, "stalls": run["stalls"]}


# ---------------------------------------------------------------------------
# phase 10: checkpoints and resilience on the training and serving paths
# ---------------------------------------------------------------------------
RES_WINDOWS = 6


def weighted_gpt2_class():
    """GPT-2 whose micro-batches carry a float weight (all ones) on the
    loss: the floating batch input the ``grads.nan`` fault site poisons
    (token ids are integers). A weight of 1.0 leaves the loss bit for bit
    what the plain model gives."""
    from deepspeed_tpu_torch import GPT2LMHeadModel

    class WeightedGPT2(GPT2LMHeadModel):
        def forward(self, input_ids, labels=None, weight=None, train=False,
                    dropout_seed=None):
            loss = super().forward(input_ids, labels, train=train,
                                   dropout_seed=dropout_seed)
            return loss * weight.mean()

    return WeightedGPT2


def res_windows(seed, vocab):
    """``RES_WINDOWS`` distinct windows of 16 x 1024 token ids, each seeded
    (seed + 100 + w), as two micro-batches (ids, labels, weight)."""
    out = []
    for w in range(RES_WINDOWS):
        micro = train_batches(seed + 100 + w, vocab)
        out.append([(ids, labels, torch.ones(8, device="cuda"))
                    for ids, labels in micro])
    return out


def res_engine(seed, optimizer="Adam", lr=1e-4, resilience=None,
               model_seed=None):
    """initialize() on GPT-2 small (WeightedGPT2) with phase 5's config
    (bf16, 8 x 2 micro-batches of 1024, dropout 0.1, WarmupLR) and the
    resilience block."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2Config

    cfg = GPT2Config.small(dropout=DROPOUT, n_layer=CUT_LAYERS)
    model = weighted_gpt2_class()(cfg, device="cuda",
                                  seed=seed if model_seed is None
                                  else model_seed)
    config = train_config(optimizer, lr, BF16)
    config["resilience"] = {"retry": {"backoff_base": 0.01},
                            **(resilience or {})}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=config, rng_seed=seed)
    return engine


def res_state(engine):
    s = engine.loss_scale_state
    return {"global_steps": engine.global_steps,
            "skipped_steps": engine.skipped_steps,
            "loss_scale": (s.loss_scale, s.good_steps, s.hysteresis),
            "lr": engine.get_lr()[0]}


def windows_losses(engine, windows):
    out = []
    for w in windows:
        out.append(float(engine.train_batch(w)))
    torch.cuda.synchronize()
    return out


def same_bits(tag, got, want):
    """Fail unless ``got`` equals ``want`` exactly: the losses are float32
    values read into Python floats, so ``==`` is bit for bit (a nan never
    passes)."""
    log(f"  {tag}: {got} vs {want}")
    if got != want:
        fail(f"{tag}: {got} differs from {want}")


def timed(fn, *args, **kwargs):
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, (time.monotonic() - t0) * 1e3


def dir_bytes(path):
    return {name: os.path.getsize(os.path.join(path, name))
            for name in sorted(os.listdir(path))}


def save_breakdown(engine, scratch_dir):
    """The parts of one save, each timed alone: the device-to-host copy of
    the masters and the optimizer state, ``torch.save`` of both files'
    payloads into memory, their atomic write with fsync, and one sha256
    pass over them (a save makes two)."""
    from deepspeed_tpu_torch.resilience import atomic_io, manifest
    from deepspeed_tpu_torch.runtime import checkpointing as ckpt

    host, d2h_ms = timed(lambda: (
        {n: ckpt._host(p) for n, p in engine.params.items()},
        ckpt._canonical_opt_state(engine)))
    t0 = time.monotonic()
    blobs = [ckpt._serialize({"module": host[0]}),
             ckpt._serialize({"num_shards": 1, "optimizer_state": host[1]})]
    ser_ms = (time.monotonic() - t0) * 1e3
    os.makedirs(scratch_dir, exist_ok=True)
    paths = [os.path.join(scratch_dir, f"part{i}") for i in range(2)]
    t0 = time.monotonic()
    for path, blob in zip(paths, blobs):
        atomic_io.atomic_write_bytes(path, blob, fsync=True)
    write_ms = (time.monotonic() - t0) * 1e3
    t0 = time.monotonic()
    for path in paths:
        manifest.file_sha256(path)
    hash_ms = (time.monotonic() - t0) * 1e3
    for path in paths:
        os.unlink(path)
    return {"d2h": d2h_ms, "serialize": ser_ms, "write_fsync": write_ms,
            "sha256_pass": hash_ms,
            "bytes": sum(len(b) for b in blobs)}


def res_counter(engine, name):
    return engine.resilience.registry.snapshot()[f"resilience/{name}"]


def phase_resilience(seed, card):
    """Phase 10. Every checkpoint goes to one temporary directory, deleted
    at the end."""
    import tempfile

    root = tempfile.mkdtemp(prefix="ds_resilience_")
    free = shutil.disk_usage(root).free
    log(f"phase 10: checkpoints under {root}; {free} bytes free on its disk")
    try:
        return resilience_runs(seed, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def resilience_runs(seed, card, root):
    import signal

    from deepspeed_tpu_torch import GPT2Config
    from deepspeed_tpu_torch.ops.fused_lamb import lamb_phase1
    from deepspeed_tpu_torch.resilience import (
        SupervisorEscalation,
        manifest,
    )

    vocab = GPT2Config.small().vocab_size
    windows = res_windows(seed, vocab)
    stats = {"card": card}
    launches = {}

    log("phase 10: run A, 6 windows uninterrupted (Adam, bf16, dropout 0.1)")
    engine = res_engine(seed)
    want = windows_losses(engine, windows)
    want_state = res_state(engine)
    log(f"  losses {want}; {want_state}")
    if not all(math.isfinite(x) for x in want):
        fail("run A: a loss is not finite")
    del engine
    torch.cuda.empty_cache()

    log("phase 10: run B, 3 windows, save with checkpoint.write armed "
        "once, a fresh engine loads and runs 3 more")
    dir_b = os.path.join(root, "run_b")
    engine = res_engine(seed, resilience={"fault_injection": {
        "enabled": True, "faults": [{"site": "checkpoint.write",
                                     "times": 1}]}})
    same_bits("run B windows 1-3 (no checkpoint yet)",
              windows_losses(engine, windows[:3]), want[:3])
    _, first_save_ms = timed(engine.save_checkpoint, dir_b)
    retries = res_counter(engine, "io_retries")
    log(f"  first save {first_save_ms:.1f} ms, io_retries {retries}")
    if retries != 1 or res_counter(engine, "faults_injected") != 1:
        fail(f"run B: io_retries {retries} after one injected write fault")
    del engine
    torch.cuda.empty_cache()
    resumed = res_engine(seed + 1, model_seed=seed + 5)
    (path, _), _ = timed(resumed.load_checkpoint, dir_b)
    if path is None or "global_step3" not in path:
        fail(f"run B: the load landed on {path}")
    zero_launches()
    got = windows_losses(resumed, windows[3:])
    launches["resume_adam"] = read_launches()
    check_launches("resumed Adam", launches["resume_adam"], 6,
                   layers=CUT_LAYERS)
    same_bits("run B windows 4-6 after the resume", got, want[3:])
    same_bits("run B counters, loss scale and LR", res_state(resumed),
              want_state)

    # one timed save and load each, to keep the script inside its time
    # limit
    log("phase 10: save and load times (one each), bytes, hashing")
    dir_t = os.path.join(root, "timing")
    saves = [timed(resumed.save_checkpoint, dir_t)[1]]
    (path, _), ms = timed(resumed.load_checkpoint, dir_t)
    if path is None:
        fail("timing: a load found nothing")
    loads = [ms]
    tag_dir = os.path.join(dir_t, f"global_step{RES_WINDOWS}")
    files = dir_bytes(tag_dir)
    state_bytes = sum(n for f, n in files.items() if f != "MANIFEST.json")
    t0 = time.monotonic()
    for f in files:
        if f != "MANIFEST.json":
            manifest.file_sha256(os.path.join(tag_dir, f))
    hash_ms = (time.monotonic() - t0) * 1e3
    save_ms, load_ms = saves[0], loads[0]
    parts = save_breakdown(resumed, dir_t)
    stats.update({
        "save_ms": save_ms, "load_ms": load_ms, "bytes_by_file": files,
        "checkpoint_bytes": state_bytes,
        "save_mb_per_s": state_bytes / 1e6 / (save_ms / 1e3),
        "load_mb_per_s": state_bytes / 1e6 / (load_ms / 1e3),
        "sha256_one_pass_ms": hash_ms,
        # a save hashes twice (the manifest, then its re-verification)
        "save_hash_share": 2 * hash_ms / save_ms,
        # a verified load hashes once
        "load_hash_share": hash_ms / load_ms,
    })
    log(f"  save {save_ms:.1f} ms, load {load_ms:.1f} ms; files {files}; {stats['save_mb_per_s']:.1f} MB/s saved, "
        f"{stats['load_mb_per_s']:.1f} MB/s loaded; one sha256 pass "
        f"{hash_ms:.1f} ms: {stats['save_hash_share']:.3f} of a save, "
        f"{stats['load_hash_share']:.3f} of a load; on {card}")
    stats["save_parts_ms"] = parts
    log(f"  a save's parts, each timed alone: {parts}")
    shutil.rmtree(dir_t)

    log("phase 10: serving run B's checkpoint (bf16, paged KV, fused decode)")
    resumed.save_checkpoint(dir_b)  # global_step6: run B's newest tag
    serve_stats = res_serving(seed, dir_b, resumed.module, launches)
    stats["serving"] = serve_stats
    del resumed
    torch.cuda.empty_cache()

    log("phase 10: corruption: truncate the newest tag's optimizer file")
    optim = os.path.join(dir_b, f"global_step{RES_WINDOWS}",
                         "zero_pp_rank_0_mp_rank_00optim_states.pt")
    blob_len = os.path.getsize(optim)
    with open(optim, "r+b") as f:
        f.truncate(blob_len // 2)
    loader = res_engine(seed + 2, model_seed=seed + 6)
    path, _ = loader.load_checkpoint(dir_b)
    fallbacks = res_counter(loader, "corruption_fallbacks")
    log(f"  latest-driven load -> {path}; corruption_fallbacks {fallbacks}")
    if path is None or "global_step3" not in path or fallbacks != 1:
        fail("corruption: the load did not fall back to global_step3 once")
    path, _ = loader.load_checkpoint(dir_b, tag=f"global_step{RES_WINDOWS}")
    if path is not None:
        fail("corruption: an explicit load of the truncated tag succeeded")
    log("  an explicit load of the truncated tag fails")
    del loader
    torch.cuda.empty_cache()
    shutil.rmtree(dir_b)

    log("phase 10: FusedLamb, 2 + 2 windows: a reload into the same engine "
        "and a fresh engine both continue bit for bit")
    dir_f = os.path.join(root, "fusedlamb")
    engine = res_engine(seed, optimizer="FusedLamb", lr=1e-3)
    windows_losses(engine, windows[:2])
    engine.save_checkpoint(dir_f)
    lamb_want = windows_losses(engine, windows[2:4])
    builds = lamb_phase1.table_builds
    engine.load_checkpoint(dir_f)
    zero_launches()
    lamb_got = windows_losses(engine, windows[2:4])
    launches["resume_fusedlamb"] = read_launches()
    check_launches("reloaded FusedLamb", launches["resume_fusedlamb"], 4, 2,
                   layers=CUT_LAYERS)
    grown = lamb_phase1.table_builds - builds
    same_bits("FusedLamb windows 3-4 after a reload", lamb_got, lamb_want)
    log(f"  LAMB table builds after the reload: {grown}")
    if grown:
        fail(f"FusedLamb: {grown} LAMB device tables built after the load")
    del engine
    torch.cuda.empty_cache()
    fresh = res_engine(seed + 3, optimizer="FusedLamb", lr=1e-3,
                       model_seed=seed + 7)
    fresh.load_checkpoint(dir_f)
    builds = lamb_phase1.table_builds
    same_bits("FusedLamb windows 3-4 in a fresh engine",
              windows_losses(fresh, windows[2:4]), lamb_want)
    stats["fusedlamb_fresh_engine_table_builds"] = (
        lamb_phase1.table_builds - builds)
    del fresh
    torch.cuda.empty_cache()
    shutil.rmtree(dir_f)

    log("phase 10: supervisor: grads.nan at window 4, checkpoint at 3")
    dir_s = os.path.join(root, "supervisor")
    sup = {"supervisor": {"enabled": True, "nonfinite_window": 1}}
    engine = res_engine(seed, resilience={**sup, "fault_injection": {
        "enabled": True, "faults": [{"site": "grads.nan", "after": 3,
                                     "times": 1}]}})
    windows_losses(engine, windows[:3])
    engine.save_checkpoint(dir_s)
    healed = windows_losses(engine, windows[3:])
    counts = {k: res_counter(engine, k)
              for k in ("rollbacks", "anomalies", "faults_injected")}
    log(f"  counters {counts}")
    if counts["rollbacks"] != 1 or counts["faults_injected"] != 1:
        fail(f"supervisor: {counts} after one poisoned window")
    same_bits("healed windows 4-6", healed, want[3:])
    same_bits("healed counters, loss scale and LR", res_state(engine),
              want_state)
    del engine
    torch.cuda.empty_cache()
    engine = res_engine(seed + 4, resilience={
        "supervisor": {"enabled": True, "nonfinite_window": 1,
                       "max_rollbacks": 1},
        "fault_injection": {"enabled": True, "faults": [
            {"site": "grads.nan", "times": 0}]}})
    engine.load_checkpoint(dir_s)
    try:
        engine.train_batch(windows[3])
        fail("supervisor: a persistent fault did not escalate")
    except SupervisorEscalation as e:
        log(f"  persistent fault -> SupervisorEscalation after "
            f"{e.rollbacks} rollback(s)")
        if e.rollbacks != 1:
            fail(f"supervisor: escalated after {e.rollbacks} rollbacks")
    del engine
    torch.cuda.empty_cache()
    shutil.rmtree(dir_s)

    log("phase 10: preemption: SIGTERM during a window, "
        "exit_after_save false")
    dir_p = os.path.join(root, "preempt")
    before = signal.getsignal(signal.SIGTERM)
    engine = res_engine(seed, resilience={"preemption": {
        "enabled": True, "save_dir": dir_p, "exit_after_save": False}})
    if signal.getsignal(signal.SIGTERM) == before:
        fail("preemption: the SIGTERM handler was not installed")
    windows_losses(engine, windows[:1])

    def signalled(micro):
        yield micro[0]
        os.kill(os.getpid(), signal.SIGTERM)
        yield micro[1]

    engine.train_batch(signalled(windows[1]))
    tag = f"preempt_global_step{engine.global_steps}"
    status, reason = manifest.verify_checkpoint(os.path.join(dir_p, tag))
    saves = res_counter(engine, "preemption_saves")
    log(f"  {tag}: {status}; preemption_saves {saves}")
    if status != manifest.VALID or saves != 1:
        fail(f"preemption: {tag} {status} ({reason}), {saves} saves")
    engine.resilience.preemption.uninstall()
    if signal.getsignal(signal.SIGTERM) != before:
        fail("preemption: the SIGTERM disposition was not restored")
    log("  handlers restored")
    del engine
    torch.cuda.empty_cache()
    shutil.rmtree(dir_p)

    log("phase 10: LoRA rank 16, 2 windows, an adapter-only checkpoint "
        "served through SGMV")
    stats["lora"] = res_lora(seed, root, windows, launches)
    return launches, stats


def res_serving(seed, ckpt_dir, trained, launches):
    """``init_inference`` from ``ckpt_dir`` against an engine built from
    the trained module's weights: the same greedy tokens through the
    flash forward and paged decode; then ``decode.step`` armed once."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    cfg = GPT2Config.small(n_layer=CUT_LAYERS)
    prompts, _ = prompts_for(seed, cfg.vocab_size)
    config = engine_config("bf16", True)
    direct = deepspeed_tpu_torch.init_inference(model=trained, config=config)
    want = direct.generate(prompts, max_new_tokens=16)
    direct.close()
    config["inference"]["checkpoint"] = {"load_dir": ckpt_dir}
    t0 = time.monotonic()
    served = deepspeed_tpu_torch.init_inference(
        model=GPT2LMHeadModel(cfg, device="cuda", seed=seed + 9),
        config=config)
    init_ms = (time.monotonic() - t0) * 1e3
    zero_launches()
    got = served.generate(prompts, max_new_tokens=16)
    torch.cuda.synchronize()
    launches["ckpt_serve"] = read_launches()
    served.close()
    log(f"  served {served.loaded_tag}; launches {launches['ckpt_serve']}")
    if got != want:
        fail("serving: the checkpoint's greedy tokens differ from the "
             "trained module's")
    if not (launches["ckpt_serve"]["flash_fwd"]
            and launches["ckpt_serve"]["paged_decode"]):
        fail("serving: the flash forward or paged decode did not launch")
    log(f"  {len(prompts)} requests: greedy tokens equal the trained "
        "module's")

    config["inference"]["driver_restart_budget"] = 1
    config["resilience"] = {"fault_injection": {"enabled": True, "faults": [
        {"site": "decode.step", "after": 1, "times": 1}]}}
    eng = deepspeed_tpu_torch.init_inference(
        model=GPT2LMHeadModel(cfg, device="cuda", seed=seed + 9),
        config=config)
    reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
    eng.scheduler.run_until_idle()
    reasons = [r.finish_reason for r in reqs]
    restarts = eng.metrics.snapshot()["infer/driver_restarts"]
    after = eng.generate(prompts, max_new_tokens=16)
    eng.close()
    log(f"  decode.step armed once: finish reasons {reasons}, "
        f"driver_restarts {restarts}")
    if None in reasons or restarts != 1:
        fail("serving: a request did not finish, or the driver did not "
             "restart once")
    if after != want:
        fail("serving: the restarted driver serves other tokens")
    return {"init_ms": init_ms, "finish_reasons_at_crash": reasons,
            "driver_restarts": restarts}


def res_lora(seed, root, windows, launches):
    """A rank-16 fine-tune (2 windows) saved as an adapter-only checkpoint;
    ``load_adapter(load_dir=)`` decodes what ``load_adapter(adapter_state=)``
    does, 48 SGMV launches a decode step; a rank-8 pool refuses it."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel
    from deepspeed_tpu_torch.adapters import split_lora_params
    from deepspeed_tpu_torch.config import DeepSpeedConfigError

    cfg = GPT2Config.small(dropout=DROPOUT, n_layer=CUT_LAYERS)
    model = GPT2LMHeadModel(cfg, device="cuda", seed=seed)
    base = {n: p.detach().clone() for n, p in model.state_dict().items()}
    config = train_config("Adam", 1e-3, BF16)
    config["adapters"] = {"enabled": True, "rank": LORA_RANK}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model,
                                                     config_params=config)
    micro = [(ids, labels) for ids, labels, _ in windows[0]]
    run_windows(engine, micro, 2)
    dir_l = os.path.join(root, "lora")
    _, save_ms = timed(engine.save_checkpoint, dir_l)
    tag_dir = os.path.join(dir_l, "global_step2")
    files = dir_bytes(tag_dir)
    saved = torch.load(os.path.join(tag_dir, "mp_rank_00_model_states.pt"),
                        weights_only=True)
    n_saved = sum(t.numel() for t in saved["module"].values())
    log(f"  adapter checkpoint: {n_saved} parameters (want "
        f"{ADAPTER_PARAMS * CUT_LAYERS // N_LAYER}), files {files}, save "
        f"{save_ms:.1f} ms")
    if n_saved != ADAPTER_PARAMS * CUT_LAYERS // N_LAYER or any(
            "_lora_" not in n
                                        for n in saved["module"]):
        fail("LoRA: the checkpoint holds more than the adapter")
    optim = torch.load(
        os.path.join(tag_dir, "zero_pp_rank_0_mp_rank_00optim_states.pt"),
        weights_only=True)["optimizer_state"]
    if set(optim["inner"]["mu"]) != set(saved["module"]):
        fail("LoRA: the optimizer file holds moments beyond the adapter")
    live = engine.adapter_state_dict()
    del engine
    torch.cuda.empty_cache()

    base = split_lora_params(base)[0]
    prompts, _ = prompts_for(seed + 1, cfg.vocab_size)
    serve_cfg = engine_config("bf16", True)
    serve_cfg["adapters"] = {"enabled": True, "rank": LORA_RANK,
                             "pool_slots": LORA_POOL_SLOTS}
    serve = deepspeed_tpu_torch.init_inference(
        model=model, model_parameters=base, config=serve_cfg)
    _, load_ms = timed(serve.load_adapter, "t", load_dir=dir_l)
    serve.load_adapter("u", adapter_state=live)
    want = serve.generate(prompts, max_new_tokens=16, adapter="u")
    steps0 = serve.metrics.histogram("infer/token_latency_ms").count
    zero_launches()
    got = serve.generate(prompts, max_new_tokens=16, adapter="t")
    torch.cuda.synchronize()
    launches["ckpt_adapter_serve"] = read_launches()
    steps = serve.metrics.histogram("infer/token_latency_ms").count - steps0
    serve.close()
    per_step = launches["ckpt_adapter_serve"]["sgmv"] / steps
    log(f"  load_adapter(load_dir=) {load_ms:.1f} ms; sgmv "
        f"{launches['ckpt_adapter_serve']['sgmv']} launches over {steps} "
        f"decode steps ({per_step} a step)")
    if got != want:
        fail("LoRA: the checkpoint's adapter decodes other tokens than its "
             "adapter_state")
    if per_step != 4 * CUT_LAYERS:  # one per target and layer
        fail(f"LoRA: {per_step} SGMV launches a decode step, want "
             f"{4 * CUT_LAYERS}")
    small_cfg = engine_config("bf16", True)
    small_cfg["adapters"] = {"enabled": True, "rank": 8,
                             "pool_slots": LORA_POOL_SLOTS}
    small = deepspeed_tpu_torch.init_inference(
        model=model, model_parameters=base, config=small_cfg)
    try:
        small.load_adapter("t", load_dir=dir_l)
        fail("LoRA: a rank-8 pool took the rank-16 checkpoint")
    except DeepSpeedConfigError as e:
        log(f"  rank-8 pool refuses it: {e}")
    small.close()
    return {"adapter_bytes_by_file": files, "adapter_save_ms": save_ms,
            "adapter_load_ms": load_ms, "adapter_params": n_saved,
            "sgmv_launches_per_decode_step": per_step}



# ---------------------------------------------------------------------------
# phase 11: the data path and remat
# ---------------------------------------------------------------------------
DATA_WINDOWS = 7
LOADER_WINDOWS = 6
# the spin kernel that holds the compute stream in the copy-overlap probe:
# about a second at the H100's clock, far longer than staging a window
HOLD_CYCLES = 2_000_000_000
REMAT_WINDOWS = 4
REMAT_SPECS = {"off": None, "full": "full",
               "selective": "dots_with_no_batch_dims_saveable+flash_out"
                            "+flash_lse"}
# forward launches a layer per micro-step under each remat mode: "full"
# runs the forward kernel again in the backward's recompute, the selective
# spec keeps its out and lse
REMAT_FWD_PER_LAYER = {"off": 1, "full": 2, "selective": 1}


def data_arrays(seed, vocab, rows, weighted=False):
    """``rows`` synthetic sequences of 1024 token ids from ``seed`` as the
    arrays of a dataset: (ids, labels), and a float weight of ones with
    ``weighted``."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, vocab, (rows, 1024), generator=g)
    out = (ids.numpy(), ids.numpy().copy())
    if weighted:
        out += (torch.ones(rows).numpy(),)
    return out


def data_engine(seed, data, staged, optimizer="Adam", lr=1e-4, model=None,
                resilience=None, accum=2):
    """initialize() with ``training_data``: GPT-2 small, phase 5's config
    (bf16, 8 x ``accum`` micro-batches of 1024, dropout 0.1, WarmupLR), and
    the data_pipeline block (2 staging buffers) when ``staged``. Returns the
    engine and its loader."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    if model is None:
        model = GPT2LMHeadModel(
            GPT2Config.small(dropout=DROPOUT, n_layer=CUT_LAYERS),
            device="cuda", seed=seed)
    config = train_config(optimizer, lr, BF16)
    config.update(train_batch_size=8 * accum,
                  gradient_accumulation_steps=accum)
    if staged:
        config["data_pipeline"] = {"enabled": True, "staging_buffers": 2}
    if resilience:
        config["resilience"] = {"retry": {"backoff_base": 0.01},
                                **resilience}
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=config, training_data=data,
        rng_seed=seed)
    return engine, loader


def htod_streams(path):
    """The host-to-device copies of a torch.profiler Chrome trace by
    stream (the trace's tid), and the stream the flash forward ran on."""
    by_stream, compute = {}, set()
    for e in trace_events(path):
        name = str(e.get("name", ""))
        if "Memcpy HtoD" in name:
            tid = str(e.get("tid"))
            by_stream[tid] = by_stream.get(tid, 0) + 1
        elif "flash_fwd_kernel" in name and e.get("ph") == "X":
            compute.add(str(e.get("tid")))
    return by_stream, compute


def profiled_windows(engine, source, trace_path, n=2):
    """``n`` train_batch windows under torch.profiler: their losses, the
    device breakdown over them (the idle share) and the Chrome trace
    written to ``trace_path``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        losses = [float(engine.train_batch(source())) for _ in range(n)]
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    prof.export_chrome_trace(trace_path)
    return losses, device_breakdown(prof, wall_ms)


def copy_overlap_probe(stager_of, step):
    """Runs ``step()`` (one train_batch window) with the compute stream
    first held in a spin kernel (``torch.cuda._sleep``), while a probe
    thread waits on the host for the first host-to-device copy that the
    stager ``stager_of()`` issues after the hold was queued (the next
    window, staged once ``step`` takes one). That copy finishing while the
    compute stream is still held shows it ran on another stream,
    overlapping the compute stream's work: a copy queued on the compute
    stream would wait for the spin. Returns ``step()``'s result and the
    probe's record; fails when the copy is not seen or waited for the
    hold."""
    import threading

    stager = stager_of()
    compute = torch.cuda.current_stream()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    held = torch.cuda.Event(enable_timing=True)
    start.record(compute)
    torch.cuda._sleep(HOLD_CYCLES)
    held.record(compute)
    before = list(stager._slot_events)
    seen = {}
    t0 = time.monotonic()

    def probe():
        try:
            while True:
                new = [e for e, b in zip(stager._slot_events, before)
                       if e is not b and e is not None]
                if new:
                    break
                if time.monotonic() - t0 > 30.0:
                    seen["error"] = "no window was staged within 30 s"
                    return
                time.sleep(0.001)
            new[0].synchronize()
            seen["copy_done_ms"] = (time.monotonic() - t0) * 1e3
            seen["compute_still_held"] = not held.query()
        except Exception as e:  # reported by the main thread
            seen["error"] = repr(e)

    thread = threading.Thread(target=probe, daemon=True)
    thread.start()
    out = step()
    thread.join(timeout=60.0)
    torch.cuda.synchronize()
    seen["hold_ms"] = start.elapsed_time(held)
    log(f"  copy-overlap probe: {seen}")
    if thread.is_alive() or "error" in seen:
        fail(f"copy-overlap probe: {seen.get('error', 'probe thread hung')}")
    if not seen["compute_still_held"]:
        fail(f"copy-overlap probe: the staged copy finished only after the "
             f"compute stream's {seen['hold_ms']:.1f} ms hold: {seen}")
    return out, seen


def engine_state(engine):
    return ({n: p.detach().clone() for n, p in engine.params.items()},
            engine._rng.get_state())


def same_state(tag, got, want):
    params_g, rng_g = got
    params_w, rng_w = want
    differ = [n for n in params_w if not torch.equal(params_g[n],
                                                     params_w[n])]
    log(f"  {tag}: {len(params_w) - len(differ)} of {len(params_w)} "
        f"parameters equal, seed generator equal: "
        f"{torch.equal(rng_g, rng_w)}")
    if differ or not torch.equal(rng_g, rng_w):
        fail(f"{tag}: parameters {differ[:4]} or the seed generator differ")


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if len(xs) % 2 else (
        xs[len(xs) // 2 - 1] + xs[len(xs) // 2]) / 2


def data_run(seed, data, path, root, tag):
    """One phase 11a run of ``path`` ("lists" or "staged"): its losses,
    final state, launches, warm window times (windows 5 on), the profile
    of windows 2-3 and, staged, the copy-overlap probe of window 4."""
    staged = path == "staged"
    engine, loader = data_engine(seed, data, staged)
    it = iter(loader)

    def source():
        return it if staged else [next(it), next(it)]

    zero_launches()
    losses, secs, probe = [], [], None
    trace = os.path.join(root, f"data_{tag}.json")
    for w in range(DATA_WINDOWS - 1):  # w = 1 runs windows 2 and 3
        if w == 1:
            got, prof = profiled_windows(engine, source, trace)
            losses += got
            continue
        if w == 2 and staged:
            loss, probe = copy_overlap_probe(
                lambda: engine._stager,
                lambda: engine.train_batch(source()))
            losses.append(float(loss))
            continue
        torch.cuda.synchronize()
        t0 = time.monotonic()
        losses.append(float(engine.train_batch(source())))
        torch.cuda.synchronize()
        if w >= 3:
            secs.append(time.monotonic() - t0)
    launches = read_launches()
    check_launches(f"phase 11a {tag}", launches, engine.micro_steps,
                   layers=CUT_LAYERS)
    by_stream, compute = htod_streams(trace)
    copy_stream = None
    if engine._stager is not None:
        copy_stream = engine._stager._copy_stream.stream_id
        if copy_stream == torch.cuda.current_stream().stream_id:
            fail("phase 11a: the stager copies on the compute stream")
    run = {
        "losses": losses, "state": engine_state(engine),
        "launches": launches, "warm_window_s": secs,
        "profile_device_idle_share": prof["device_idle_share"],
        "profile_device_busy_ms": prof["device_busy_ms"],
        "profile_wall_ms": prof["wall_ms"],
        "htod_by_stream": by_stream, "compute_streams": sorted(compute),
        "stager_used": engine._stager is not None,
        "copy_stream_id": copy_stream, "copy_probe": probe,
    }
    log(f"  {tag}: losses {losses}; warm windows {secs} s; profiled "
        f"windows 2-3 idle share {prof['device_idle_share']:.4f} (busy "
        f"{prof['device_busy_ms']:.1f} of {prof['wall_ms']:.1f} ms); HtoD "
        f"copies by stream {by_stream}, compute stream {sorted(compute)}")
    engine.close_data_pipeline()
    del engine, loader
    torch.cuda.empty_cache()
    return run


def data_staged_vs_lists(seed, card, root):
    """Phase 11a: the staged loader against the same windows as lists,
    in the order lists, staged, staged, lists."""
    from deepspeed_tpu_torch import GPT2Config

    vocab = GPT2Config.small().vocab_size
    data = data_arrays(seed + 11, vocab, 16 * DATA_WINDOWS)
    runs = [data_run(seed, data, path, root, f"{path}{i}")
            for i, path in enumerate(("lists", "staged", "staged",
                                      "lists"))]
    want = runs[0]
    for i, r in enumerate(runs[1:], 1):
        same_bits(f"phase 11a run {i} losses vs run 0", r["losses"],
                  want["losses"])
        same_state(f"phase 11a run {i} vs run 0", r["state"], want["state"])
    out = {}
    for path in ("lists", "staged"):
        mine = [r for r in runs if (r["stager_used"] == (path == "staged"))]
        if len(mine) != 2:
            fail(f"phase 11a: {len(mine)} runs of {path} used the stager "
                 "as asked, want 2")
        secs = [s for r in mine for s in r["warm_window_s"]]
        out[path] = {
            "losses": want["losses"],
            "launches": {k: sum(r["launches"][k] for r in mine)
                         for k in mine[0]["launches"]},
            "step_ms": median(secs) * 1e3,
            "step_ms_by_run": [median(r["warm_window_s"]) * 1e3
                               for r in mine],
            "profile_device_idle_share": [
                r["profile_device_idle_share"] for r in mine],
            "profile_device_busy_ms": [r["profile_device_busy_ms"]
                                       for r in mine],
            "profile_wall_ms": [r["profile_wall_ms"] for r in mine],
            "htod_by_stream": [r["htod_by_stream"] for r in mine],
            "compute_streams": [r["compute_streams"] for r in mine],
        }
        log(f"  {path}: step {out[path]['step_ms']:.3f} ms (median of "
            f"windows 5-{DATA_WINDOWS} of two runs; by run "
            f"{out[path]['step_ms_by_run']}); idle share "
            f"{out[path]['profile_device_idle_share']}; on {card}")
    # the copy-overlap probe of each staged run shows the copies run on
    # the copy stream beside the compute stream's work; the traces of
    # windows 2-3 must show no host-to-device copy on the compute stream.
    # The profiler does not hold every copy in every run (a list-path
    # window has shown 2 of its 4, a staged one none), so the copies it
    # shows on other streams are recorded, not counted on.
    out["staged"]["copy_probe"] = [r["copy_probe"] for r in runs
                                   if r["stager_used"]]
    on_copy = 0
    for r in runs:
        if not r["stager_used"]:
            continue
        on_compute = sum(n for t, n in r["htod_by_stream"].items()
                         if t in r["compute_streams"])
        on_copy += sum(r["htod_by_stream"].values()) - on_compute
        if len(r["compute_streams"]) != 1 or on_compute:
            fail(f"phase 11a: the staged run copied host-to-device on the "
                 f"compute stream {r['compute_streams']}: "
                 f"{r['htod_by_stream']}")
    out["staged"]["htod_seen_on_copy_stream"] = on_copy
    log(f"  staged: {on_copy} host-to-device copies seen on the copy stream, "
        "none on the compute stream")
    return out


def loader_run(seed, data, staged):
    """One phase 11a run at one micro-batch a window: the loader staging
    its own batches (the data_pipeline block) or its host batches fed as
    lists. Its losses, final state, launches, warm window times (windows
    4 on) and, staged, the copy-overlap probe of window 3 on the loader's
    stager."""
    engine, loader = data_engine(seed, data, staged, accum=1)
    it = iter(loader)
    zero_launches()
    losses, secs, probe = [], [], None
    for w in range(LOADER_WINDOWS):
        if w == 2 and staged:
            loss, probe = copy_overlap_probe(lambda: it.stager,
                                             lambda: engine.train_batch(it))
            losses.append(float(loss))
            continue
        torch.cuda.synchronize()
        t0 = time.monotonic()
        losses.append(float(engine.train_batch(it if staged else [next(it)])))
        torch.cuda.synchronize()
        if w >= 3:
            secs.append(time.monotonic() - t0)
    launches = read_launches()
    check_launches(f"phase 11a accum 1 {'staged' if staged else 'lists'}",
                   launches, engine.micro_steps, layers=CUT_LAYERS)
    stager = getattr(it, "stager", None)
    if (stager is not None) != staged or engine._stager is not None:
        fail(f"phase 11a accum 1: the loader's stager {stager}, the "
             f"engine's {engine._stager}; want only the loader's, staged")
    state = engine_state(engine)
    engine.close_data_pipeline()
    if staged and not stager.closed:
        fail("phase 11a accum 1: close_data_pipeline left the loader's "
             "stager running")
    log(f"  accum 1 {'staged' if staged else 'lists'}: losses {losses}; "
        f"warm windows {secs} s")
    del engine, loader, it
    torch.cuda.empty_cache()
    return {"losses": losses, "state": state, "launches": launches,
            "step_ms": median(secs) * 1e3, "copy_probe": probe}


def loader_staged_vs_lists(seed, card):
    """Phase 11a at one micro-batch a window, where the loader stages its
    own batches and train_batch adds no stager: equal bit for bit to the
    same batches fed as lists."""
    from deepspeed_tpu_torch import GPT2Config

    data = data_arrays(seed + 13, GPT2Config.small().vocab_size,
                       8 * LOADER_WINDOWS)
    want = loader_run(seed, data, False)
    got = loader_run(seed, data, True)
    same_bits("phase 11a accum 1 staged losses vs lists", got["losses"],
              want["losses"])
    same_state("phase 11a accum 1 staged vs lists", got["state"],
               want["state"])
    out = {}
    for path, r in (("lists", want), ("staged", got)):
        out[path] = {k: r[k] for k in ("losses", "launches", "step_ms")}
        log(f"  accum 1 {path}: step {r['step_ms']:.3f} ms (median of "
            f"windows 4-{LOADER_WINDOWS}); on {card}")
    out["staged"]["copy_probe"] = got["copy_probe"]
    return out


def remat_run(seed, micro, mode):
    """One phase 11b run under remat ``mode``: 3 windows of FusedLamb;
    its losses, peak memory, warm window times and launches."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    spec = REMAT_SPECS[mode]
    kw = {} if spec is None else {"remat": True, "remat_policy": spec}
    model = GPT2LMHeadModel(
        GPT2Config.small(dropout=DROPOUT, n_layer=CUT_LAYERS, **kw),
        device="cuda", seed=seed)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=train_config("FusedLamb", 1e-3, BF16),
        rng_seed=seed)
    zero_launches()
    losses, secs, _ = run_windows(engine, micro, REMAT_WINDOWS)
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    m = engine.micro_steps
    want = {name: CUT_LAYERS * m for name in TRAIN_KERNELS}
    want["flash_fwd"] = CUT_LAYERS * m * REMAT_FWD_PER_LAYER[mode]
    want["lamb_phase1"] = 6 * engine.global_steps
    want["paged_decode"] = want["sgmv"] = 0
    log(f"  remat {mode}: losses {losses}; launches {launches}; peak "
        f"{peak} bytes; windows {secs} s")
    if launches != want:
        fail(f"phase 11b remat {mode}: launches {launches} differ from "
             f"{want}")
    del engine, model
    torch.cuda.empty_cache()
    return {"losses": losses, "peak_bytes": peak, "warm_window_s": secs[1:],
            "launches": launches,
            "launches_per_micro_step": {k: v / m for k, v in launches.items()
                                        if k in TRAIN_KERNELS}}


def remat_runs(seed, card):
    """Phase 11b: remat off, "full" and the selective spec, in the order
    off, full, selective, selective, full, off."""
    from deepspeed_tpu_torch import GPT2Config

    micro = train_batches(seed, GPT2Config.small().vocab_size)
    order = ("off", "full", "selective", "selective", "full", "off")
    by_mode = {mode: [] for mode in REMAT_SPECS}
    for mode in order:
        by_mode[mode].append(remat_run(seed, micro, mode))
    runs = {}
    for mode, rs in by_mode.items():
        secs = [s for r in rs for s in r["warm_window_s"]]
        runs[mode] = {
            "spec": REMAT_SPECS[mode], "losses": rs[0]["losses"],
            "peak_bytes": [r["peak_bytes"] for r in rs],
            "step_ms": median(secs) * 1e3,
            "step_ms_by_run": [median(r["warm_window_s"]) * 1e3 for r in rs],
            "launches": {k: sum(r["launches"][k] for r in rs)
                         for k in rs[0]["launches"]},
            "launches_per_micro_step": rs[0]["launches_per_micro_step"],
        }
        log(f"  remat {mode}: step {runs[mode]['step_ms']:.3f} ms (median "
            f"of windows 2-{REMAT_WINDOWS} of two runs; by run "
            f"{runs[mode]['step_ms_by_run']}); peak "
            f"{runs[mode]['peak_bytes']} bytes; on {card}")
        for r in rs:
            same_bits(f"phase 11b remat {mode} losses vs off", r["losses"],
                      by_mode["off"][0]["losses"])
    if not max(runs["full"]["peak_bytes"]) < min(runs["off"]["peak_bytes"]):
        fail(f"phase 11b: remat full peaks at {runs['full']['peak_bytes']} "
             f"bytes, not below remat off's {runs['off']['peak_bytes']}")
    for mode in ("full", "selective"):
        log(f"phase 11b: one float32 micro-step under remat {mode}, "
            "kernels vs plain")
        cfg = GPT2Config.small(dropout=0.0, remat=True, n_layer=CUT_LAYERS,
                               remat_policy=REMAT_SPECS[mode])
        f32, err = grads_kernels_vs_plain(seed, cfg)
        want = {name: CUT_LAYERS for name in TRAIN_KERNELS}
        want["flash_fwd"] = CUT_LAYERS * REMAT_FWD_PER_LAYER[mode]
        want["lamb_phase1"] = want["paged_decode"] = want["sgmv"] = 0
        if f32 != want:
            fail(f"phase 11b float32 remat {mode}: launches {f32} differ "
                 f"from {want}")
        runs[mode]["f32_grad_max_rel_err"] = err
        runs[mode]["f32_launches"] = f32
    return runs


def supervised_loader_runs(seed, card, root):
    """Phase 11c: a supervised, staged run fed by the loader through a
    ReplayableDataSource heals a poisoned window and a dead staging
    worker, bit for bit."""
    from deepspeed_tpu_torch import GPT2Config
    from deepspeed_tpu_torch.resilience import ReplayableDataSource

    cfg = GPT2Config.small(dropout=DROPOUT, n_layer=CUT_LAYERS)
    data = data_arrays(seed + 12, cfg.vocab_size, 16 * 5, weighted=True)
    sup = {"supervisor": {"enabled": True, "nonfinite_window": 1}}

    def run(faults):
        model = weighted_gpt2_class()(cfg, device="cuda", seed=seed)
        res = dict(sup)
        if faults:
            res["fault_injection"] = {"enabled": True, "faults": faults}
        engine, loader = data_engine(seed, data, True, model=model,
                                     resilience=res)
        src = ReplayableDataSource(loader.iter_from)
        losses = [float(engine.train_batch(src)) for _ in range(2)]
        engine.save_checkpoint(os.path.join(root, "sup"))
        losses += [float(engine.train_batch(src)) for _ in range(3)]
        torch.cuda.synchronize()
        snap = engine.resilience.registry.snapshot()
        counts = {k: snap.get(f"resilience/{k}", 0)
                  for k in ("rollbacks", "anomalies", "faults_injected")}
        state = engine_state(engine)
        engine.close_data_pipeline()
        del engine, loader, model
        torch.cuda.empty_cache()
        shutil.rmtree(os.path.join(root, "sup"), ignore_errors=True)
        return losses, counts, state

    log("phase 11c: supervised staged run from the loader, unpoisoned")
    want, _, want_state = run(None)
    log("phase 11c: the same with grads.nan in window 3, then one "
        "staging.worker death")
    got, counts, got_state = run([
        {"site": "grads.nan", "after": 2, "times": 1},
        {"site": "staging.worker", "after": 5, "times": 1},
    ])
    log(f"  counters {counts}")
    if counts["rollbacks"] != 2 or counts["faults_injected"] != 2:
        fail(f"phase 11c: {counts}, want 2 rollbacks of 2 injected faults")
    same_bits("phase 11c healed losses", got, want)
    same_state("phase 11c healed run", got_state, want_state)
    return {"losses": got, "counters": counts}


def phase_data_remat(seed, card):
    """Phase 11. The profiler traces and checkpoints go to one temporary
    directory, deleted at the end."""
    import tempfile

    root = tempfile.mkdtemp(prefix="ds_data_remat_")
    try:
        log(f"phase 11a: the staged loader against the list path, "
            f"{DATA_WINDOWS} windows of Adam")
        data = data_staged_vs_lists(seed, card, root)
        log(f"phase 11a: the loader staging its own batches at accum 1 "
            f"against the list path, {LOADER_WINDOWS} windows of Adam")
        loader = loader_staged_vs_lists(seed, card)
        log(f"phase 11b: remat off, full and selective, {REMAT_WINDOWS} "
            "windows of FusedLamb each, in the order off, full, selective, "
            "selective, full, off")
        remat = remat_runs(seed, card)
        supervised = supervised_loader_runs(seed, card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {name: {} for name in launch_counters()}
    for path, r in data.items():
        for name, n in r["launches"].items():
            launches[name][f"data_{path}"] = n
    for path, r in loader.items():
        for name, n in r["launches"].items():
            launches[name][f"data_accum1_{path}"] = n
    for mode, r in remat.items():
        for name, n in r["launches"].items():
            launches[name][f"remat_{mode}"] = n
    return launches, {"card": card, "data": data, "data_accum1": loader,
                      "remat": remat, "supervised": supervised}


# ---------------------------------------------------------------------------
# phase 12: BERT (non-causal padded flash) and the optimizer state layouts
# ---------------------------------------------------------------------------
BERT_SHAPE = (8, 16, 512, 64)  # B, H, S, D: BERT-large, micro-batch 8
BERT_SEQ, BERT_QA_SEQ = 512, 384
BERT_WINDOWS, BERT_QA_WINDOWS, LAYOUT_WINDOWS = 4, 3, 3
BERT_LR = 1e-3
CROSSOVER_SEQS = (128, 256, 384, 512)
# lengths of BERT_SHAPE's rows for the kernel checks: full, ragged and a
# dead row (index 2)
BERT_LENGTHS = (512, 300, 0, 129, 511, 128, 400, 64)


def bert_mask(device, lengths, s):
    mask = torch.zeros(len(lengths), s, dtype=torch.int32, device=device)
    for row, n in enumerate(lengths):
        mask[row, :n] = 1
    return mask


def check_flash_bert(device, gen):
    """flash_fwd, flash_bwd_dq and flash_bwd_dkv non-causal at BERT-large's
    shape with the padding mask (ragged lengths, a dead row), dropout 0 and
    0.1, float32, bfloat16 and float16, against their plain versions at
    phase 3b's tolerances; the dead row's output and gradients exact zeros.
    Returns the max errors by (kernel, dtype)."""
    from deepspeed_tpu_torch.ops import attention as A

    b, h, s, d = BERT_SHAPE
    mask = bert_mask(device, BERT_LENGTHS, s)
    dead = BERT_LENGTHS.index(0)
    base = [torch.randn(b, h, s, d, device=device, generator=gen)
            for _ in range(4)]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        q, k, v, dout = (t.to(dtype) for t in base)
        for rate in (0.0, DROPOUT):
            tag = f"{str(dtype)[6:]} non-causal mask" + (
                "+dropout" if rate else "")
            args = (q, k, v, mask, False, None, rate, 2468)
            out, lse = A.flash_fwd(*args)
            torch.cuda.synchronize()
            ref, ref_lse = A.flash_fwd_plain(*args)
            err = check_close(f"flash_fwd {tag}", out, ref, dtype)
            errs[("flash_fwd", dtype)] = max(errs.get(("flash_fwd", dtype),
                                                  0.0), err)
            rows = ref_lse > -1e29
            check_close(f"flash_fwd {tag} lse", lse[rows], ref_lse[rows],
                        torch.float32)
            if not bool((out[dead] == 0).all()):
                fail(f"flash_fwd {tag}: the dead row is not exact zeros")
            delta = (dout.float() * ref.float()).sum(dim=-1)
            bargs = (q, k, v, mask, dout, ref_lse, delta, False, None, rate,
                     2468)
            got = (A.flash_bwd_dq(*bargs), *A.flash_bwd_dkv(*bargs))
            torch.cuda.synchronize()
            want = (A.flash_bwd_dq_plain(*bargs),
                    *A.flash_bwd_dkv_plain(*bargs))
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                kernel = "flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"
                err = check_close(f"{kernel} {name} {tag}", g, w, dtype,
                                  scaled=True)
                errs[(kernel, dtype)] = max(errs.get((kernel, dtype), 0.0),
                                            err)
                if not bool((g[dead] == 0).all()):
                    fail(f"{kernel} {name} {tag}: the dead row's gradient "
                         "is not exact zeros")
            del out, lse, ref, ref_lse, delta, got, want
    return errs


# lengths at the key tiles' edges (64-key dQ tiles, 128-key forward and
# dK/dV tiles; 32- and 64-key tiles at D = 256)
EDGE_LENGTHS = (63, 64, 65, 127, 128, 129, 255, 256, 257)
MASK_PATTERNS = ("edges", "left", "hole", "dead")


def mask_pattern(pattern, s, device):
    """A [9, s] int32 key mask: ``edges`` right padding at EDGE_LENGTHS,
    ``left`` left padding at them, ``hole`` rows whose middle keys are
    masked (one spans a whole 128-key tile) beside full rows, ``dead`` a
    row with no valid key between ragged ones, ``ones`` every key valid
    (tests/test_torch_cuda_kernels.py builds the same masks)."""
    b = len(EDGE_LENGTHS)
    mask = torch.zeros(b, s, dtype=torch.int32)
    if pattern == "ones":
        mask[:] = 1
    for row, n in enumerate(EDGE_LENGTHS):
        if pattern == "edges":
            mask[row, :n] = 1
        elif pattern == "left":
            mask[row, s - n:] = 1
        elif pattern == "hole":
            mask[row] = 1
            if row % 2:
                mask[row, n // 2:n // 2 + 64 + n] = 0
        elif pattern == "dead":
            mask[row, :max(0, n - 8 * row)] = 1 if row != 4 else 0
    return mask.to(device)


def tile_classes(mask, tile):
    """The shares of (batch row, key tile of ``tile`` keys) pairs with no
    valid key, every key valid, and some: what the tensor-core kernels
    skip, run mask-free and mask (csrc/key_tiles.cuh)."""
    b, s = mask.shape
    n = (s + tile - 1) // tile
    padded = torch.zeros(b, n * tile, dtype=torch.int32, device=mask.device)
    padded[:, :s] = mask != 0
    valid = padded.view(b, n, tile).sum(dim=-1)
    width = torch.full((n,), tile, device=mask.device)
    width[-1] = s - (n - 1) * tile
    pairs = b * n
    empty = int((valid == 0).sum())
    full = int((valid == width).sum())
    return {"tile_keys": tile, "pairs": pairs, "empty": empty / pairs,
            "full": full / pairs, "mixed": (pairs - empty - full) / pairs}


def check_flash_mask_patterns(device, gen):
    """The forward, dQ and dK/dV under MASK_PATTERNS at S = 512, D = 64,
    128 and 256, non-causal, float32, bfloat16 and float16, dropout 0 and
    0.1, against their plain versions at phase 3b's tolerances; rows that
    see no key and masked keys' gradient rows exact zeros; and an all-ones
    mask bit for bit kv_mask=None's in bfloat16 (every tile full: the
    mask-free path). Returns {D: {kernel: max error}} and the checks'
    count."""
    from deepspeed_tpu_torch.ops import attention as A

    s, h = BERT_SHAPE[2], 4
    errs, checks = {}, 0
    for d in (64, 128, 256):
        base = [torch.randn(len(EDGE_LENGTHS), h, s, d, device=device,
                            generator=gen) for _ in range(4)]
        per = errs.setdefault(d, {})
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            q, k, v, dout = (t.to(dtype) for t in base)
            for pattern in MASK_PATTERNS:
                mask = mask_pattern(pattern, s, device)
                for rate in (0.0, DROPOUT):
                    tag = (f"d{d} {str(dtype)[6:]} {pattern}"
                           + (" +dropout" if rate else ""))
                    fargs = (q, k, v, mask, False, None, rate, 4321)
                    out, lse = A.flash_fwd(*fargs)
                    ref, ref_lse = A.flash_fwd_plain(*fargs)
                    delta = (dout.float() * ref.float()).sum(dim=-1)
                    bargs = (q, k, v, mask, dout, ref_lse, delta, False,
                             None, rate, 4321)
                    got = (A.flash_bwd_dq(*bargs), *A.flash_bwd_dkv(*bargs))
                    torch.cuda.synchronize()
                    want = (A.flash_bwd_dq_plain(*bargs),
                            *A.flash_bwd_dkv_plain(*bargs))
                    e = check_close(f"flash_fwd {tag}", out, ref, dtype)
                    per["flash_fwd"] = max(per.get("flash_fwd", 0.0), e)
                    rows = ref_lse > -1e29
                    check_close(f"flash_fwd {tag} lse", lse[rows],
                                ref_lse[rows], torch.float32)
                    for name, g, w in zip(("dq", "dk", "dv"), got, want):
                        kernel = ("flash_bwd_dq" if name == "dq"
                                  else "flash_bwd_dkv")
                        e = check_close(f"{kernel} {name} {tag}", g, w,
                                        dtype, scaled=True)
                        per[kernel] = max(per.get(kernel, 0.0), e)
                    dead_keys = (mask == 0)[:, None, :, None].expand_as(
                        got[1])
                    if not (bool((out[~rows] == 0).all())
                            and bool((got[0][~rows] == 0).all())
                            and bool((got[1][dead_keys] == 0).all())
                            and bool((got[2][dead_keys] == 0).all())):
                        fail(f"flash {tag}: a row with no key or a masked "
                             "key's gradient is not exact zeros")
                    checks += 1
                    del out, lse, ref, ref_lse, delta, got, want
        q, k, v, dout = (t.to(torch.bfloat16) for t in base)
        ones = mask_pattern("ones", s, device)
        for rate in (0.0, DROPOUT):
            results = []
            for mask in (ones, None):
                out, lse = A.flash_fwd(q, k, v, mask, False, None, rate, 77)
                delta = (dout.float() * out.float()).sum(dim=-1)
                bargs = (q, k, v, mask, dout, lse, delta, False, None, rate,
                         77)
                results.append((out, lse, A.flash_bwd_dq(*bargs),
                                *A.flash_bwd_dkv(*bargs)))
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(*results)):
                fail(f"flash d{d} bf16 rate {rate}: an all-ones mask is not "
                     "kv_mask=None bit for bit")
            log(f"  d{d} bf16 rate {rate}: all-ones mask == no mask, bit "
                "for bit (out, lse, dq, dk, dv)")
        del base, q, k, v, dout
        torch.cuda.empty_cache()
    return errs, checks


def time_flash_bert(device, gen, timer, errs):
    """Rows 1b-3b: the three kernels at BERT-large's shape, bf16,
    non-causal with the padding mask and dropout 0.1: Timer both ways, the
    plain version, SDPA with the same boolean mask (forward; its whole
    backward) and the bound of this mask's visible pairs."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import attention as A

    b, h, s, d = BERT_SHAPE
    bf = torch.bfloat16
    mask = bert_mask(device, BERT_LENGTHS, s)
    q, k, v, dout = (torch.randn(b, h, s, d, device=device, generator=gen)
                     .to(bf) for _ in range(4))
    out, lse = A.flash_fwd(q, k, v, mask, False, None, DROPOUT, 11)
    delta = (dout.float() * out.float()).sum(dim=-1)
    keep = (mask != 0)[:, None, None, :]
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep,
                                              dropout_p=DROPOUT)
    lib = {
        "fwd": lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=keep, dropout_p=DROPOUT),
        "bwd": lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), dout,
                                           retain_graph=True),
    }
    lib_ms = {key: (timer.ms(fn), timer.ms(fn, spin=True))
              for key, fn in lib.items()}
    fargs = (q, k, v, mask, False, None, DROPOUT, 11)
    bargs = (q, k, v, mask, dout, lse, delta, False, None, DROPOUT, 11)
    shape = ("B=8 H=16 S=512 D=64 non-causal, padding mask (lengths "
             f"{list(BERT_LENGTHS)}), dropout 0.1, bf16")
    bwd_lib = ("scaled_dot_product_attention backward with the same "
               "boolean mask (dQ, dK and dV together), dropout 0.1")
    out_rows = {}
    for name, src, tpu, fn, plain, args, which, key, lib_name in (
        ("flash_fwd", FLASH_SOURCE, FLASH_TPU, A.flash_fwd, A.flash_fwd_plain,
         fargs, "fwd", "fwd", "scaled_dot_product_attention forward with "
         "the same boolean mask, dropout 0.1"),
        ("flash_bwd_dq", BWD_SOURCE, DQ_TPU, A.flash_bwd_dq,
         A.flash_bwd_dq_plain, bargs, "dq", "bwd", bwd_lib),
        ("flash_bwd_dkv", BWD_SOURCE, DKV_TPU, A.flash_bwd_dkv,
         A.flash_bwd_dkv_plain, bargs, "dkv", "bwd", bwd_lib),
    ):
        nbytes, flops = flash_work(q, mask, False, which)
        b_ms, b_by = bound(nbytes, flops, bf)
        call = lambda: fn(*args)
        out_rows[f"{name} bert"] = dict(
            name=f"{name} bert", route="cuda",
            route_detail=ROUTE[name] + "; non-causal, padding mask",
            source=src, replaces=tpu, tpu_kernel=tpu, shape=shape,
            max_abs_err=errs[(name, bf)],
            max_abs_err_f32=errs[(name, torch.float32)],
            max_abs_err_f16=errs[(name, torch.float16)],
            ms=timer.ms(call), device_ms=timer.ms(call, spin=True),
            plain_ms=timer.ms(lambda: plain(*args), iters=3, warmup=1),
            library_ms=lib_ms[key][0], library_device_ms=lib_ms[key][1],
            library=lib_name, bound_ms=b_ms, bound_by=b_by,
            bound_bytes=nbytes, bound_flops=flops,
            # the key tiles this mask leaves empty, full and mixed at the
            # kernel's tile width (dK/dV: its 128-key blocks)
            tiles=tile_classes(mask, 64 if which == "dq" else 128))
        log(f"  {name} bert: {json.dumps(out_rows[f'{name} bert'])}")
    del out, lse, delta, qg, kg, vg, sdpa_out
    return out_rows


def flash_crossover(device, gen, timer):
    """Flash (forward + backward through the kernels) against
    mha_reference (forward + backward through PyTorch) at BERT-large's
    attention (B=8, H=16, D=64, bf16, a padding mask of lengths 3/4 of S
    and S, no dropout) at each of CROSSOVER_SEQS: where FLASH_MIN_SEQ
    should sit on this card. Timer both ways: as it gives it (host
    enqueue and autograd included) and behind a 20M-cycle spin (the
    device work alone)."""
    from deepspeed_tpu_torch.ops import attention as A

    out = {}
    b, h, _, d = BERT_SHAPE
    for s in CROSSOVER_SEQS:
        q, k, v, dout = (torch.randn(b, h, s, d, device=device, generator=gen)
                         .to(torch.bfloat16).requires_grad_()
                         for _ in range(4))
        mask = bert_mask(device, [s, s * 3 // 4] * (b // 2), s)
        additive = torch.where(mask[:, None, None, :] > 0, 0.0,
                               A.NEG_INF).float()

        def flash():
            o = A.flash_attention(q, k, v, kv_mask=mask)
            return torch.autograd.grad(o, (q, k, v), dout)

        def plain():
            o = A.mha_reference(q, k, v, mask=additive)
            return torch.autograd.grad(o, (q, k, v), dout)

        out[s] = {"flash_ms": timer.ms(flash, iters=10),
                  "mha_reference_ms": timer.ms(plain, iters=10),
                  "flash_device_ms": timer.ms(flash, iters=10, spin=True,
                                              spin_cycles=20_000_000),
                  "mha_reference_device_ms": timer.ms(
                      plain, iters=10, spin=True, spin_cycles=20_000_000)}
        log(f"  seq {s}: flash fwd+bwd {out[s]['flash_ms']:.4f} ms "
            f"(device {out[s]['flash_device_ms']:.4f}), mha_reference "
            f"fwd+bwd {out[s]['mha_reference_ms']:.4f} ms (device "
            f"{out[s]['mha_reference_device_ms']:.4f})")
        del q, k, v, dout
    return out


def bert_batches(seed, cfg, seq, kind, micro=8, accum=2):
    """``accum`` micro-batches of ``micro`` sequences on the card: lengths
    drawn in [128, seq], ids in the valid positions (0 past them), two
    segments, and for pretraining 15% of the valid positions as masked-LM
    labels (the rest -100) and NSP labels, for QA start/end positions
    inside the valid part."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(accum):
        lengths = torch.randint(128, seq + 1, (micro,), generator=g)
        pos = torch.arange(seq)[None, :]
        valid = pos < lengths[:, None]
        ids = torch.where(valid, torch.randint(
            1, cfg.vocab_size, (micro, seq), generator=g), 0)
        tt = (pos >= (lengths[:, None] // 2)).long() * valid
        mask = valid.int()
        if kind == "pretraining":
            pick = (torch.rand(micro, seq, generator=g) < 0.15) & valid
            labels = torch.where(pick, ids, -100)
            tail = (labels, torch.randint(0, 2, (micro,), generator=g))
        else:
            start = (torch.rand(micro, generator=g) * (lengths - 8)).long()
            tail = (start, start + torch.randint(0, 8, (micro,),
                                                 generator=g))
        out.append(tuple(t.cuda() for t in (ids, mask, tt, *tail)))
    return out


def bert_config(optimizer, lr):
    return {
        "train_batch_size": 16,
        "train_micro_batch_size_per_gpu": 8,
        "gradient_accumulation_steps": 2,
        "bf16": {"enabled": True},
        "gradient_clipping": 1.0,
        "optimizer": {"type": optimizer, "params": {"lr": lr,
                                                    "weight_decay": 0.01}},
        "steps_per_print": 1000,
    }


def lamb_launches_per_step(engine):
    """FusedLamb's launches a step for the engine's groups: one per group
    above multi_tensor_max, one for the rest when there are two or more."""
    from deepspeed_tpu_torch.ops.optimizers import param_groups

    limit = engine.optimizer_obj.multi_tensor_max
    sizes = [sum(engine.params[n].numel() for n in names)
             for names in param_groups(engine.params).values()]
    small = sum(1 for n in sizes if limit and n <= limit)
    return len(sizes) if small < 2 else len(sizes) - small + 1


def bert_train(seed, card, kind, optimizer, lr, seq, windows, profile):
    """initialize() on BERT-large at full width and depth and ``windows``
    train_batch windows on one fixed batch: losses, window times, peak
    memory, the launches of the run (counts set to 0 just before it) and
    per micro-step, and a profiled window."""
    import deepspeed_tpu_torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from deepspeed_tpu_torch import (BertConfig, BertForPreTraining,
                                     BertForQuestionAnswering)

    cfg = BertConfig.bert_large(max_position_embeddings=512)
    cls = BertForPreTraining if kind == "pretraining" else (
        BertForQuestionAnswering)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = cls(cfg, device="cuda", seed=seed)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=bert_config(optimizer, lr), rng_seed=seed)
    micro = bert_batches(seed, cfg, seq, kind)
    zero_launches()
    losses, secs, _ = run_windows(engine, micro, windows)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    log(f"  {kind}: losses {losses}; windows {secs} s; peak {peak} bytes; "
        f"launches {launches}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"phase 12 {kind}: the loss is not finite or did not fall "
             f"({losses})")
    if engine.skipped_steps or engine.global_steps != windows:
        fail(f"phase 12 {kind}: {engine.skipped_steps} skipped steps")
    m = engine.micro_steps
    want = {k: cfg.num_hidden_layers * m for k in TRAIN_KERNELS}
    want["lamb_phase1"] = (lamb_launches_per_step(engine) * windows
                           if optimizer == "FusedLamb" else 0)
    if any(launches[k] != want[k] for k in want):
        fail(f"phase 12 {kind}: launches {launches}, want {want}")
    per_micro = {k: launches[k] / m for k in TRAIN_KERNELS}
    per_micro["lamb_phase1_per_step"] = launches["lamb_phase1"] / windows
    log(f"  {kind}: launches per micro-step {per_micro}")
    prof_stats = None
    if profile:
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            engine.train_batch(iter(micro))
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
        prof_stats = device_breakdown(prof, wall_ms)
        log(json.dumps({f"bert_{kind}_profile": prof_stats}))
        del prof
    stats = {"losses": losses, "window_s": secs,
             "step_ms": median(secs[1:]) * 1e3, "peak_bytes": peak,
             "launches": launches, "launches_per_micro_step": per_micro,
             "tokens_per_step": 16 * seq,
             "profile_device_idle_share": (prof_stats or {}).get(
                 "device_idle_share"),
             "profile_device_ms_by_class": (prof_stats or {}).get(
                 "device_ms_by_class")}
    return engine, micro, stats


def bert_grads_kernels_vs_plain(seed):
    """One float32 micro-step of BERT-large cut to 2 layers at seq 512,
    dropout 0, padded rows: gradients through the kernels against those
    through the plain versions, max|diff| / max|plain| per parameter
    within TOL[float32]. Returns the launches and the worst error."""
    from deepspeed_tpu_torch import BertConfig, BertForPreTraining
    from deepspeed_tpu_torch.ops import attention as A

    import dataclasses

    cfg = dataclasses.replace(
        BertConfig.bert_large(hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0),
        num_hidden_layers=2)
    model = BertForPreTraining(cfg, device="cuda", seed=seed)
    batch = bert_batches(seed, cfg, BERT_SEQ, "pretraining", accum=1)[0]

    def grads(plain):
        kernels = (A.flash_fwd, A.flash_bwd_dq, A.flash_bwd_dkv)
        if plain:
            A.flash_fwd, A.flash_bwd_dq, A.flash_bwd_dkv = (
                plain_flash_fwd, A.flash_bwd_dq_plain,
                A.flash_bwd_dkv_plain)
        try:
            loss = model(*batch, train=True)
            return [g.float() for g in torch.autograd.grad(
                loss, list(model.parameters()))]
        finally:
            A.flash_fwd, A.flash_bwd_dq, A.flash_bwd_dkv = kernels

    zero_launches()
    got = grads(False)
    torch.cuda.synchronize()
    launches = read_launches()
    want = grads(True)
    err = max(float((a - w).abs().max() / w.abs().max().clamp_min(1e-30))
              for a, w in zip(got, want))
    log(f"  float32 BERT-large (2 layers) micro-step: gradients max|diff| / "
        f"max|plain| {err:.3e} (tol {TOL[torch.float32]:g}); launches "
        f"{launches}")
    if err > TOL[torch.float32]:
        fail("BERT float32 gradients through the kernels disagree with the "
             "plain versions'")
    if any(launches[k] != 2 for k in TRAIN_KERNELS):
        fail(f"BERT 2-layer micro-step launches {launches}, want 2 each")
    del model
    return launches, err


def bert_qa_logits_vs_plain(engine, micro):
    """The trained QA module's train=False start/end logits (its float32
    masters) through the kernels against the plain versions: the flash
    forward launches once a layer, the logits within TOL[float32] of
    their scale."""
    from deepspeed_tpu_torch.ops import attention as A

    model = engine.module
    ids, mask, tt = micro[0][:3]
    kernels = (A.flash_fwd, A.flash_bwd_dq, A.flash_bwd_dkv)
    zero_launches()
    with torch.no_grad():
        got = model(ids, mask, tt, train=False)
        torch.cuda.synchronize()
        launches = read_launches()
        A.flash_fwd = plain_flash_fwd
        try:
            want = model(ids, mask, tt, train=False)
        finally:
            A.flash_fwd, A.flash_bwd_dq, A.flash_bwd_dkv = kernels
    errs = [check_close(f"QA {name} logits (kernels vs plain)", g, w,
                        torch.float32, scaled=True)
            for name, g, w in zip(("start", "end"), got, want)]
    if launches["flash_fwd"] != model.config.num_hidden_layers:
        fail(f"QA eval forward launched {launches}")
    return launches, max(errs)


LAYOUT_RUNS = {
    # name: (optimizer, lr, config extra, client optimizer)
    "adam_fp32": ("Adam", 1e-4, {}, None),
    "adam_bf16_state": ("Adam", 1e-4,
                        {"data_types": {"optimizer_state_dtype": "bf16"}},
                        None),
    "adam_int8_state": ("Adam", 1e-4,
                        {"data_types": {"optimizer_state_dtype": "int8"}},
                        None),
    "adam_compensated": ("Adam", 1e-4,
                         {"data_types": {"master_dtype": "compensated"}},
                         None),
    # bf16 parameters without codes: compensated storage with a client
    # Adam, which the engine leaves uncompensated (the JAX rule)
    "adam_bf16_params": ("Adam", 1e-4,
                         {"data_types": {"master_dtype": "compensated"}},
                         "Adam"),
    "adam_offload": ("Adam", 1e-4, {"zero_optimization": {
        "offload_optimizer": {"device": "cpu"}}}, None),
    "lion": ("Lion", 3e-5, {}, None),
    "sgd": ("SGD", 1e-1, {}, None),
}


def layout_config(optimizer, lr, extra):
    cfg = {
        "train_batch_size": 16,
        "train_micro_batch_size_per_gpu": 8,
        "gradient_accumulation_steps": 2,
        **BF16,
        "gradient_clipping": 1.0,
        "optimizer": {"type": optimizer, "params": dict(
            {"lr": lr}, **({"momentum": 0.9} if optimizer == "SGD" else {}))},
        "steps_per_print": 1000,
    }
    cfg.update(extra)
    return cfg


def layout_engine(seed, name):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel
    from deepspeed_tpu_torch.ops.optimizers import Adam

    optimizer, lr, extra, client = LAYOUT_RUNS[name]
    model = GPT2LMHeadModel(GPT2Config.small(dropout=DROPOUT), device="cuda",
                            seed=seed)
    with torch.no_grad():
        # weights on the bf16 grid: every layout starts from the same
        # values (compensated codes start at zero, as in the JAX engine,
        # and would otherwise drop the init's rounding error)
        for p in model.parameters():
            p.copy_(p.to(torch.bfloat16))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=layout_config(optimizer, lr, extra),
        optimizer=Adam() if client else None, rng_seed=seed)
    return engine


def host_state(engine):
    """The engine's masters, module parameters and optimizer state on the
    host (for bit-for-bit comparisons)."""
    def leaves(tree, prefix=""):
        if isinstance(tree, torch.Tensor):
            yield prefix, tree.detach().cpu()
        elif isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{prefix}/{k}")

    return {"params": {n: p.detach().cpu() for n, p in engine.params.items()},
            "module": {n: p.detach().cpu()
                       for n, p in engine.module_params.items()},
            "state": dict(leaves(engine.optimizer_state))}


def same_host_state(tag, got, want):
    for part in ("params", "module", "state"):
        if set(got[part]) != set(want[part]):
            fail(f"{tag}: {part} names differ")
        for n, w in want[part].items():
            if got[part][n].dtype != w.dtype or not torch.equal(
                    got[part][n], w):
                fail(f"{tag}: {part} {n} differs")


def layout_runs(seed, card):
    """Phase 12d: GPT-2 small at full width and depth, phase 5's training
    shape without a schedule, LAYOUT_WINDOWS windows of each layout on the
    same fixed batch: the step ms, the peak memory (reset before each run)
    and the launches; offload equal to the fp32 Adam run bit for bit;
    compensated nearer the fp32 run than bf16 parameters without codes;
    int8 and offload resume bit for bit through a checkpoint."""
    import tempfile

    from deepspeed_tpu_torch import GPT2Config

    from deepspeed_tpu_torch.ops import quant

    micro = train_batches(seed, GPT2Config.small().vocab_size)
    out, masters, resume = {}, {}, {}
    root = tempfile.mkdtemp(prefix="ds_layouts_")
    try:
        for name in LAYOUT_RUNS:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            engine = layout_engine(seed, name)
            zero_launches()
            losses, secs, _ = run_windows(engine, micro, LAYOUT_WINDOWS)
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated()
            log(f"  {name}: losses {losses}; windows {secs} s; peak {peak} "
                f"bytes")
            if not all(math.isfinite(x) for x in losses) or not (
                    losses[-1] < losses[0]):
                fail(f"phase 12d {name}: the loss is not finite or did not "
                     f"fall ({losses})")
            check_launches(f"phase 12d {name}", launches, engine.micro_steps)
            out[name] = {"losses": losses, "window_s": secs,
                         "step_ms": median(secs[1:]) * 1e3,
                         "peak_bytes": peak, "launches": launches}
            state = host_state(engine)
            if name == "adam_compensated":
                # the master the codes carry
                comp = engine.optimizer_state["comp"]
                state["params"] = {
                    n: quant.decode_master(p.detach(), comp[n]).cpu()
                    for n, p in engine.params.items()}
            masters[name] = state
            if name == "adam_offload":
                compare_offload(state, masters["adam_fp32"])
            if name in ("adam_int8_state", "adam_offload"):
                resume[name] = resume_check(seed, name, engine, micro, root)
            del engine
    finally:
        shutil.rmtree(root, ignore_errors=True)
    base = masters["adam_fp32"]["params"]
    if out["adam_offload"]["losses"] != out["adam_fp32"]["losses"]:
        fail("phase 12d: offload's losses differ from the on-device Adam "
             "run's")
    log("  offload == on-device Adam: losses, masters and published "
        "parameters bit for bit")

    # compensated against bf16 parameters without codes, both against the
    # fp32-master run: parameter distance and loss gap
    def distance(params):
        return math.sqrt(sum(float(((params[n].float() - base[n]) ** 2).sum())
                             for n in base))

    dist = {k: distance(masters[k]["params"])
            for k in ("adam_compensated", "adam_bf16_params")}
    gap = {k: sum(abs(a - b) for a, b in zip(out[k]["losses"],
                                             out["adam_fp32"]["losses"]))
           for k in dist}
    log(f"  distance to the fp32 masters {dist}; summed loss gap {gap}")
    if not dist["adam_compensated"] < dist["adam_bf16_params"]:
        fail("phase 12d: compensated parameters are not nearer the fp32 "
             "masters than bf16 parameters without codes")
    if not gap["adam_compensated"] <= gap["adam_bf16_params"]:
        fail("phase 12d: compensated losses track the fp32 run no closer "
             "than bf16 parameters without codes")
    del masters
    torch.cuda.empty_cache()
    return out, {"distance_to_fp32_masters": dist, "loss_gap": gap,
                 "resume": resume}


def compare_offload(offload, base):
    """Offload's masters against the on-device Adam run's, and its device
    parameters against those masters in bf16, bit for bit."""
    for n, p in base["params"].items():
        if not torch.equal(offload["params"][n], p):
            fail(f"phase 12d: offload's master {n} differs from the "
                 "on-device Adam run's")
        if not torch.equal(offload["module"][n], p.to(torch.bfloat16)):
            fail(f"phase 12d: offload's published {n} is not the master "
                 "in bf16")


def resume_check(seed, name, engine, micro, root):
    """Save after the run's windows, train one more window; a fresh engine
    of another seed loads the checkpoint and trains the same window: the
    loss, masters, parameters and every state tensor bit for bit."""
    t0 = time.monotonic()
    engine.save_checkpoint(root, tag=name)
    save_s = time.monotonic() - t0
    cont = run_windows(engine, micro, 1)[0]
    want = host_state(engine)
    fresh = layout_engine(seed + 1, name)
    fresh.load_checkpoint(root, tag=name)
    got = run_windows(fresh, micro, 1)[0]
    if got != cont:
        fail(f"phase 12d {name}: resumed loss {got} != {cont}")
    same_host_state(f"phase 12d {name} resume", host_state(fresh), want)
    if name == "adam_offload" and not all(
            p.is_pinned() for p in fresh.params.values()):
        fail("phase 12d: restored offload masters are not pinned")
    log(f"  {name}: resumed bit for bit (save {save_s:.2f} s)")
    del fresh
    shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    return {"loss": cont, "save_s": save_s}


def phase_bert_layouts(seed, card):
    """Phase 12. Returns ({kernel: {path: launches}}, stats, rows 1b-3b)."""
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(seed + 12)
    timer = Timer(device)
    log("phase 12a: flash forward, dQ and dK/dV non-causal with a padding "
        "mask at BERT-large's shape vs plain")
    errs = check_flash_bert(device, gen)
    log("phase 12a: the mask patterns (lengths at the tiles' edges, left "
        "padding, holes, dead rows; all-ones == no mask) at D = 64, 128, 256")
    pattern_errs, pattern_checks = check_flash_mask_patterns(device, gen)
    rows = time_flash_bert(device, gen, timer, errs)
    log("phase 12a: the FLASH_MIN_SEQ crossover (flash vs mha_reference, "
        "forward + backward)")
    crossover = flash_crossover(device, gen, timer)
    del timer
    torch.cuda.empty_cache()
    launches = {name: {} for name in launch_counters()}
    log(f"phase 12b: BERT-large pretraining, seq {BERT_SEQ}, FusedLamb, "
        f"bf16, dropout 0.1, micro-batch 8 x 2, {BERT_WINDOWS} windows")
    engine, _, pre = bert_train(seed, card, "pretraining", "FusedLamb",
                                BERT_LR, BERT_SEQ, BERT_WINDOWS, True)
    coeffs = engine.lamb_coeffs
    if not bool(torch.isfinite(coeffs).all()):
        fail("phase 12b: LAMB trust ratios not finite")
    pre["lamb_coeffs_min_max"] = [float(coeffs.min()), float(coeffs.max())]
    pre["lamb_launches_per_step"] = lamb_launches_per_step(engine)
    del engine
    torch.cuda.empty_cache()
    for name, n in pre["launches"].items():
        launches[name]["bert_pretraining"] = n
    log("phase 12b: one float32 micro-step, kernels vs plain (2 layers)")
    f32_launches, grad_err = bert_grads_kernels_vs_plain(seed)
    pre["f32_grad_max_rel_err"] = grad_err
    for name, n in f32_launches.items():
        launches[name]["bert_f32_grads"] = n
    torch.cuda.empty_cache()
    log(f"phase 12c: BERT-large QA, seq {BERT_QA_SEQ}, Adam, "
        f"{BERT_QA_WINDOWS} windows")
    engine, micro, qa = bert_train(seed, card, "qa", "Adam", 1e-4,
                                   BERT_QA_SEQ, BERT_QA_WINDOWS, False)
    for name, n in qa["launches"].items():
        launches[name]["bert_qa"] = n
    eval_launches, qa["eval_logits_max_rel_err"] = bert_qa_logits_vs_plain(
        engine, micro)
    for name, n in eval_launches.items():
        launches[name]["bert_qa_eval"] = n
    del engine, micro
    torch.cuda.empty_cache()
    log(f"phase 12d: optimizer state layouts on GPT-2 small, "
        f"{LAYOUT_WINDOWS} windows each")
    layouts, layout_checks = layout_runs(seed, card)
    for run, r in layouts.items():
        for name, n in r["launches"].items():
            launches[name][f"layout_{run}"] = n
    for row in rows.values():
        row["launches"] = sum(
            launches[row["name"].split()[0]].get(p, 0)
            for p in ("bert_pretraining", "bert_qa", "bert_qa_eval",
                      "bert_f32_grads"))
        row["launches_by_path"] = {
            p: launches[row["name"].split()[0]].get(p, 0)
            for p in ("bert_pretraining", "bert_qa", "bert_qa_eval",
                      "bert_f32_grads")}
    return launches, {"card": card, "crossover": crossover,
                      "mask_patterns": {"checks": pattern_checks,
                                        "max_abs_err": pattern_errs},
                      "bert_pretraining": pre, "bert_qa": qa,
                      "layouts": layouts, "layout_checks": layout_checks}, rows


# ---------------------------------------------------------------------------
# phase 13: the rest of inference — the contiguous cache, the host tier
# and speculative decoding
# ---------------------------------------------------------------------------
INF_SLOTS = 8
CONTIG_LENGTHS = (128, 183, 238, 293, 348, 403, 457, 512)
CONTIG_NEW = 32
# the tier's pool and new tokens: 8 requests of a wave need ~168 pages
# (their shared 32-page template and ~17 pages each), over the pool's
# 144, so the wave preempts; a pool of 8 slots x 64 pages holds all
TIER_POOL = 144
TIER_BYTES = 2 << 30
TIER_NEW = 192
TIER_SUFFIXES = (32, 46, 59, 73, 87, 101, 114, 128)
TIER_WAVES = ((0,) * 8, (1,) * 8, (2,) * 4 + (0,) * 4)  # template per slot
TIER_PAGE_CHECKS = 64    # promoted pages held bit for bit against the tier
SPEC_K = 4
SPEC_LENGTHS = (128, 146, 164, 183, 201, 219, 238, 256)
SPEC_NEW = 64
SPEC_MAX_SEQ = 512
# a bfloat16 greedy trajectory may leave another route's at a near-tie:
# the target's top-2 logit gap at the first divergence must lie under
# 2**-4 (8 bf16 ulps at logits of magnitude 1-2; the two attention routes
# round p and the output at different points, a few ulps per layer)
BF16_FLIP_TOL = 0.0625


def inf_engine(model, dtype, draft=None, extra=None, **inference):
    """An engine over ``model`` with 8 slots, greedy, ``dtype``, and the
    ``inference`` keys (``extra``: other top-level config blocks)."""
    import deepspeed_tpu_torch

    block = {"max_batch_slots": INF_SLOTS, "dtype": dtype,
             "sampling": {"greedy": True}}
    block.update(inference)
    return deepspeed_tpu_torch.init_inference(
        model=model, config={"inference": block, **(extra or {})},
        draft_model=draft)


def random_tokens(g, n, vocab):
    return torch.randint(0, vocab, (n,), generator=g).tolist()


def run_requests(engine, prompts, new, join_after=None):
    """Serve ``prompts`` (``new`` tokens each); with ``join_after`` the
    last prompt joins after that many scheduler steps of the others."""
    t0 = time.monotonic()
    head = prompts if join_after is None else prompts[:-1]
    reqs = [engine.submit(p, max_new_tokens=new) for p in head]
    if join_after is not None:
        for _ in range(join_after):
            engine.scheduler.step()
        reqs.append(engine.submit(prompts[-1], max_new_tokens=new))
    engine.scheduler.run_until_idle()
    torch.cuda.synchronize()
    return [r.result() for r in reqs], engine_stats(
        engine, time.monotonic() - t0)


def top2_gap(model, tokens, vocab):
    """The top-2 logit gap of ``model``'s next-token logits after
    ``tokens`` (its full forward)."""
    with torch.no_grad():
        logits = model(torch.tensor([tokens], device=model.wte.device))[
            0, -1, :vocab]
    top2 = torch.topk(logits.float(), 2).values
    return float(top2[0] - top2[1])


def same_tokens(tag, prompts, got, want, model, vocab):
    """Float32 greedy tokens must be equal; on a difference fail with the
    first position and the top-2 gap there."""
    for r, (a, b) in enumerate(zip(got, want)):
        if a != b:
            step = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                        min(len(a), len(b)))
            gap = top2_gap(model, prompts[r] + b[:step], vocab)
            fail(f"{tag}: request {r} differs at step {step} (lengths "
                 f"{len(a)}/{len(b)}, top-2 logit gap {gap:.3e})")


def bf16_divergence(tag, prompts, got, want, model, vocab):
    """Report where two bfloat16 trajectories part (first request and
    position, the target's top-2 logit gap there) and require the gap to
    be a near-tie, under BF16_FLIP_TOL."""
    for r, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        step = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    min(len(a), len(b)))
        gap = top2_gap(model, prompts[r] + b[:step], vocab)
        log(f"  {tag}: bf16 trajectories part at request {r} step {step}, "
            f"top-2 logit gap {gap:.4e} (tolerance {BF16_FLIP_TOL})")
        if gap >= BF16_FLIP_TOL:
            fail(f"{tag}: bf16 divergence at a top-2 gap of {gap:.4e} >= "
                 f"{BF16_FLIP_TOL}: not a near-tie")
        return {"request": r, "step": step, "top2_gap": gap}
    return None


def rollout_check(tag, model, prompts, outs, vocab):
    """Each request's tokens are the full forward's greedy rollout: one
    teacher-forced forward over prompt + tokens, whose argmax at every
    position from the prompt's last equals the next token."""
    for r, (p, out) in enumerate(zip(prompts, outs)):
        ids = torch.tensor([p + out[:-1]], device=model.wte.device)
        with torch.no_grad():
            logits = model(ids)[0, len(p) - 1:, :vocab]
        if not bool(torch.isfinite(logits).all()):
            fail(f"{tag}: request {r}: full-forward logits not finite")
        want = logits.argmax(-1).tolist()
        if want != out:
            step = next(i for i, (x, y) in enumerate(zip(want, out))
                        if x != y)
            top2 = torch.topk(logits[step].float(), 2).values
            fail(f"{tag}: request {r} leaves the full forward's rollout at "
                 f"step {step} (top-2 gap {float(top2[0] - top2[1]):.3e})")


def check_window(tag, got, must, must_not=()):
    for name in must:
        if got[name] <= 0:
            fail(f"{tag}: {name} launched no time on this path ({got})")
    for name in must_not:
        if got[name]:
            fail(f"{tag}: {name} launched {got[name]} times ({got})")


def phase_contig(seed, card, model, vocab):
    """Phase 13a. Returns (launches, stats)."""
    g = torch.Generator().manual_seed(seed + 130)
    prompts = [random_tokens(g, n, vocab) for n in CONTIG_LENGTHS]
    contig = dict(max_seq_len=1024)
    paged = dict(max_seq_len=1024, kv_block_size=16, fused_decode=True)
    log("phase 13a: contiguous cache, float32: tokens vs the paged engine "
        "and the full forward's rollout")
    e = inf_engine(model, "fp32", **contig)
    out_c, _ = run_requests(e, prompts, CONTIG_NEW, join_after=2)
    e.close()
    e = inf_engine(model, "fp32", **paged)
    out_p, _ = run_requests(e, prompts, CONTIG_NEW, join_after=2)
    e.close()
    same_tokens("13a contiguous vs paged (fp32)", prompts, out_c, out_p,
                model, vocab)
    rollout_check("13a contiguous (fp32)", model, prompts, out_c, vocab)
    log(f"  float32: contiguous == paged == rollout for {len(prompts)} "
        f"requests x {CONTIG_NEW} tokens")
    torch.cuda.empty_cache()

    log("phase 13a: contiguous cache, bf16 (the measured path)")
    warm = inf_engine(model, "bf16", **contig)
    run_requests(warm, prompts[:1], 4)
    warm.close()
    e = inf_engine(model, "bf16", **contig)
    zero_launches()
    out_cb, st = run_requests(e, prompts, CONTIG_NEW, join_after=2)
    launches = read_launches()
    cache_bytes = e.metrics.gauge("infer/kv_cache_bytes").value
    bf16_model = e.model
    check_window("13a contig", launches, ("flash_fwd",),
                 ("paged_decode", "sgmv", "flash_bwd_dq"))
    # the contiguous cache has no prefix cache: every prefill is cold
    if launches["flash_fwd"] != N_LAYER * st["requests"]:
        fail(f"13a: flash_fwd launched {launches['flash_fwd']} times for "
             f"{st['requests']} cold prefills (want {N_LAYER} each)")
    want_bytes = INF_SLOTS * 1024 * N_LAYER * 2 * 768 * 2
    if cache_bytes != want_bytes:
        fail(f"13a: cache bytes {cache_bytes} != {want_bytes}")
    ep = inf_engine(model, "bf16", **paged)
    out_pb, st_p = run_requests(ep, prompts, CONTIG_NEW, join_after=2)
    ep.close()
    div = bf16_divergence("13a contiguous vs paged", prompts, out_cb,
                          out_pb, bf16_model, vocab)
    e.close()
    stats = {
        "ttft_ms_mean": st["ttft_ms_mean"],
        "prefill_ms_mean": st["prefill_ms_mean"],
        "decode_tokens_per_s": decode_rate(st),
        "decode_steps": st["decode_steps"],
        "cold_prefills": st["requests"],
        "flash_fwd_per_cold_prefill": launches["flash_fwd"]
        / st["requests"],
        "cache_bytes": cache_bytes,
        "paged_ttft_ms_mean": st_p["ttft_ms_mean"],
        "paged_decode_tokens_per_s": decode_rate(st_p),
        "bf16_divergence": div,
        "wall_s": st["wall_s"],
    }
    log(f"  contiguous bf16: TTFT {st['ttft_ms_mean']:.3f} ms, decode "
        f"{decode_rate(st):.1f} tokens/s (paged {decode_rate(st_p):.1f}), "
        f"cache {cache_bytes} bytes, launches {launches} on {card}")
    return launches, stats


def tier_prompts(seed, vocab):
    g = torch.Generator().manual_seed(seed + 131)
    templates = [random_tokens(g, 512, vocab) for _ in range(3)]
    waves = [[templates[t] + random_tokens(g, s, vocab)
              for t, s in zip(wave, TIER_SUFFIXES)] for wave in TIER_WAVES]
    return templates, waves


class TierProbe:
    """Wraps a host-tier engine's seams: times each page spill and each
    promoted chain (host clock: the device-to-host copy and its wait, the
    sha1, the placement), and holds every promoted page (up to
    TIER_PAGE_CHECKS) bit for bit against its tier entry once the slot's
    reservation has put it in the pool."""

    def __init__(self, engine):
        self.engine = engine
        self.spill_ms, self.promote_ms, self.promoted = [], [], 0
        self.checked = 0
        self._pending = None
        self.first_prefill = {}  # prompt -> when its first prefill ended
        spill, promote = engine._spill_kv_page, engine._promote_chain
        reserve, prefill = engine.reserve_request, engine.prefill_request

        def timed_prefill(slot, prompt, temperature):
            first = prefill(slot, prompt, temperature)
            # a preempted request resumes with its tokens appended: only
            # its first admission counts toward time to first token
            self.first_prefill.setdefault(tuple(prompt), time.monotonic())
            return first

        def timed_spill(block_id, chain_hash):
            t0 = time.perf_counter()
            spill(block_id, chain_hash)
            self.spill_ms.append((time.perf_counter() - t0) * 1e3)

        def timed_promote(hashes, start, plen):
            t0 = time.perf_counter()
            out = promote(hashes, start, plen)
            if out:
                self.promote_ms.append((time.perf_counter() - t0) * 1e3)
                self.promoted += len(out)
            # the tier entries (the spilled bytes, verified against their
            # spill-time digest) of the chain, page start onward
            entries = engine.host_tier._entries
            self._pending = (start, [entries[h].arrays for h, _, _ in out
                                     if h in entries])
            return out

        def checked_reserve(slot, prompt, max_new):
            self._pending = None
            prefix_len = reserve(slot, prompt, max_new)
            if self._pending is not None:
                start, arrays = self._pending
                # the pages promoted into this slot (the chain may have
                # been cut to fit a suffix bucket)
                n = prefix_len // engine.kv_block_size - start
                blocks = engine._slot_blocks[slot]
                for i in range(max(0, min(n, len(arrays)))):
                    if self.checked >= TIER_PAGE_CHECKS:
                        break
                    b = blocks[start + i]
                    for pool, want in zip(
                            (engine._cache.k, engine._cache.v), arrays[i]):
                        if not torch.equal(pool[:, b].cpu(), want):
                            fail(f"13b: promoted page {b} differs from its "
                                 "spilled bytes")
                    self.checked += 1
            return prefix_len

        engine._spill_kv_page = timed_spill
        engine.block_pool._spill_fn = timed_spill
        engine._promote_chain = timed_promote
        engine.reserve_request = checked_reserve
        engine.prefill_request = timed_prefill

    def ttft_ms(self, requests):
        """Time to first token of each request's first admission (the
        infer/ttft_ms histogram also counts a preempted request's resume,
        measured from its submission)."""
        return [(self.first_prefill[tuple(r.prompt_tokens)]
                 - r.submitted_at) * 1e3 for r in requests]

    def spill_parts(self, pages=32):
        """Where a page spill's host time goes, over ``pages`` pages of the
        pool: the pinned allocation of its k and v rows (kept alive, as
        the tier keeps them, so each is a fresh allocation; and the same
        bytes as one allocation), the copies and the wait on the stream,
        and the sha1 the tier takes of them."""
        from deepspeed_tpu_torch.inference.host_tier import _digest

        cache = self.engine._cache
        parts = {"pin_alloc_ms": 0.0, "copy_wait_ms": 0.0, "sha1_ms": 0.0,
                 "pin_alloc_one_buffer_ms": 0.0}
        held = []
        for b in range(1, pages + 1):
            rows = (cache.k[:, b], cache.v[:, b])
            t0 = time.perf_counter()
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in rows]
            t1 = time.perf_counter()
            for h, t in zip(host, rows):
                h.copy_(t, non_blocking=True)
            torch.cuda.current_stream().synchronize()
            t2 = time.perf_counter()
            _digest(host)
            t3 = time.perf_counter()
            one = torch.empty((2,) + tuple(rows[0].shape),
                              dtype=rows[0].dtype, pin_memory=True)
            t4 = time.perf_counter()
            held.extend((host, one))
            for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                parts[key] += dt * 1e3 / pages
        return parts

    def stats(self):
        per_page = (sum(self.promote_ms) / self.promoted
                    if self.promoted else None)
        return {"spills_timed": len(self.spill_ms),
                "spill_ms_per_page": (sum(self.spill_ms) / len(self.spill_ms)
                                      if self.spill_ms else None),
                "promote_ms_per_page_fetched": per_page,
                "pages_fetched": self.promoted,
                "pages_checked_bitwise": self.checked}


def tier_block(group, **kw):
    return dict({"enabled": True, "max_bytes": TIER_BYTES,
                 "share_group": group, "lazy_alloc": True}, **kw)


def tier_run(engine, waves, probe=None):
    """The 24 requests, wave after wave; with a probe, the mean time to
    first token of their first admissions."""
    outs, ttft, t0 = [], [], time.monotonic()
    for wave in waves:
        reqs = [engine.submit(p, max_new_tokens=TIER_NEW) for p in wave]
        engine.scheduler.run_until_idle()
        torch.cuda.synchronize()
        outs.extend(r.result() for r in reqs)
        if probe is not None:
            ttft.extend(probe.ttft_ms(reqs))
    st = engine_stats(engine, time.monotonic() - t0)
    if ttft:
        st["ttft_ms_first_admission_mean"] = sum(ttft) / len(ttft)
        st["ttft_ms_first_admission_max"] = max(ttft)
    return outs, st


def tier_counts(engine):
    snap = engine.kv_snapshot()
    return {k[len("host_tier_"):]: v for k, v in snap.items()
            if k.startswith("host_tier_")}


def phase_tier(seed, card, model, vocab):
    """Phase 13b. Returns (launches, stats)."""
    templates, waves = tier_prompts(seed, vocab)
    flat = [p for wave in waves for p in wave]
    paged = dict(max_seq_len=1024, kv_block_size=16, fused_decode=True)
    log(f"phase 13b: host tier, float32: 24 requests in 3 waves on a "
        f"{TIER_POOL}-page pool (lazy growth) vs a pool that holds all")
    a = inf_engine(model, "fp32", kv_pool_blocks=TIER_POOL,
                   host_tier=tier_block("p13-f32"), **paged)
    probe = TierProbe(a)
    out_t, st_t = tier_run(a, waves, probe)
    counts = tier_counts(a)
    ref = inf_engine(model, "fp32", kv_pool_blocks=INF_SLOTS * 64, **paged)
    out_r, _ = tier_run(ref, waves)
    same_tokens("13b tier vs resident (fp32)", flat, out_t, out_r, model,
                vocab)
    for key in ("spills", "promotions", "preemptions"):
        if counts[key] <= 0:
            fail(f"13b: host_tier/{key} is {counts[key]} ({counts})")
    if probe.checked == 0:
        fail("13b: no promoted page was held against its spilled bytes")
    log(f"  float32: tier == resident for 24 requests; {counts}; "
        f"{probe.stats()}")
    # a peer engine in the same share group: its first templated request
    # promotes the pages engine A parked
    peer_prompt = templates[0] + random_tokens(
        torch.Generator().manual_seed(seed + 132), 40, vocab)
    b = inf_engine(model, "fp32", kv_pool_blocks=TIER_POOL,
                   host_tier=tier_block("p13-f32"), **paged)
    if b.host_tier is not a.host_tier:
        fail("13b: the two engines of one share group hold two tiers")
    out_b, _ = run_requests(b, [peer_prompt], 32)
    peer = tier_counts(b)
    out_rb, _ = run_requests(ref, [peer_prompt], 32)
    same_tokens("13b peer vs resident (fp32)", [peer_prompt], out_b, out_rb,
                model, vocab)
    if peer["peer_fetches"] <= 0:
        fail(f"13b: the peer engine's first request fetched nothing from "
             f"its peer ({peer})")
    for e in (b, a, ref):
        e.close()
    torch.cuda.empty_cache()

    log("phase 13b: adapters through the tier (3 adapters, 2 pool rows), "
        "float32")
    base = {k: v for k, v in model.state_dict().items()}
    adapters = {n: synthetic_adapter(base, seed + 133 + i)
                for i, n in enumerate("abc")}
    g = torch.Generator().manual_seed(seed + 134)
    ad_prompts = [random_tokens(g, 64, vocab) for _ in range(2)]
    ad_f32 = adapter_tier_run(model, "fp32", "p13-ad-f32", adapters,
                              ad_prompts, True)
    ad_ref = adapter_tier_run(model, "fp32", None, adapters, ad_prompts,
                              False)
    if ad_f32["tokens"] != ad_ref["tokens"]:
        fail(f"13b: the auto-loaded adapter's tokens differ from the "
             f"all-resident run's ({ad_f32['tokens']} vs "
             f"{ad_ref['tokens']})")
    log(f"  adapter b evicted, parked and auto-loaded: tokens == "
        f"all-resident; {ad_f32['counts']}")

    log("phase 13b: host_tier.copy armed once (oserror): the template "
        "serves cold")
    fault = fault_run(model, seed, vocab)
    log(f"  {fault}")
    torch.cuda.empty_cache()

    log("phase 13b: bf16 (the measured path)")
    warm = inf_engine(model, "bf16", kv_pool_blocks=TIER_POOL,
                      host_tier=tier_block("p13-warm"), **paged)
    run_requests(warm, flat[:1], 4)
    warm.close()
    a = inf_engine(model, "bf16", kv_pool_blocks=TIER_POOL,
                   host_tier=tier_block("p13-bf16"), **paged)
    probe = TierProbe(a)
    zero_launches()
    _, st = tier_run(a, waves, probe)
    ad_bf16 = adapter_tier_run(model, "bf16", "p13-ad-bf16", adapters,
                               ad_prompts, True)
    launches = read_launches()
    counts_b = tier_counts(a)
    spill_parts = probe.spill_parts()
    a.close()
    check_window("13b host_tier", launches,
                 ("flash_fwd", "paged_decode", "sgmv"),
                 ("flash_bwd_dq", "lamb_phase1"))
    for key in ("spills", "promotions", "preemptions"):
        if counts_b[key] <= 0:
            fail(f"13b bf16: host_tier/{key} is {counts_b[key]}")
    page_bytes = N_LAYER * 16 * 2 * 768 * 2
    stats = {
        "ttft_ms_mean": st["ttft_ms_mean"],
        "ttft_ms_first_admission_mean": st["ttft_ms_first_admission_mean"],
        "ttft_ms_first_admission_max": st["ttft_ms_first_admission_max"],
        "prefill_ms_mean": st["prefill_ms_mean"],
        "decode_tokens_per_s": decode_rate(st),
        "decode_steps": st["decode_steps"],
        "cold_prefills": st["cold_prefills"],
        "prefix_hits": st["prefix_hits"],
        "wall_s": st["wall_s"],
        "counts": counts_b, "probe": probe.stats(),
        "spill_parts": spill_parts,
        "f32_ttft_ms_first_admission_mean":
            st_t["ttft_ms_first_admission_mean"],
        "page_bytes": page_bytes,
        "f32_counts": counts, "f32_peer_counts": peer,
        "adapters": {"f32": ad_f32["counts"], "bf16": ad_bf16["counts"],
                     "bf16_sgmv_launches": ad_bf16["sgmv_launches"]},
        "fault": fault,
    }
    log(f"  spill parts (ms a page): {spill_parts}")
    log(f"  host tier bf16: TTFT {st['ttft_ms_mean']:.3f} ms (first "
        f"admissions {st['ttft_ms_first_admission_mean']:.3f}), decode "
        f"{decode_rate(st):.1f} tokens/s, {counts_b}, {probe.stats()}, "
        f"launches {launches} on {card}")
    return launches, stats


def adapter_tier_run(model, dtype, group, adapters, prompts, tier):
    """Load a and b into a pool of 2 rows (3 without the tier: all
    resident), serve a, load c (b, idle, is evicted and parked), then
    serve b. Returns b's tokens, the tier counts and the SGMV launches."""
    engine = inf_engine(
        model, dtype, max_seq_len=1024, kv_block_size=16,
        fused_decode=True,
        **({"host_tier": tier_block(group, lazy_alloc=False)}
           if tier else {}),
        extra={"adapters": {"enabled": True, "rank": LORA_RANK,
                            "pool_slots": 2 if tier else 3}})
    try:
        for name in "ab":
            engine.load_adapter(name, adapter_state=adapters[name])
        gen_b = engine.adapter_registry.generation_of("b")
        engine.generate([prompts[0]], max_new_tokens=8, adapter="a")
        engine.load_adapter("c", adapter_state=adapters["c"])
        if tier and "b" in engine.adapter_registry.loaded:
            fail("13b: adapter b was not evicted")
        before = launch_counters()["sgmv"].launches
        out = engine.generate([prompts[1]], max_new_tokens=16,
                              adapter="b")[0]
        sgmv = launch_counters()["sgmv"].launches - before
        counts = tier_counts(engine) if tier else {}
        if tier:
            if engine.adapter_registry.generation_of("b") != gen_b:
                fail("13b: the auto-load did not restore b's generation")
            if counts["promotions"] < 1 or counts["spills"] < 1:
                fail(f"13b: adapter b did not spill and promote ({counts})")
        return {"tokens": out, "counts": counts, "sgmv_launches": sgmv}
    finally:
        engine.close()


def fault_run(model, seed, vocab):
    """A 6-page pool with host_tier.copy armed once (oserror): the first
    spill (the template's first page) is skipped, so the template's
    second serve reads cold, equal to its first; copy_faults counts 1."""
    g = torch.Generator().manual_seed(seed + 135)
    template = random_tokens(g, 40, vocab)
    churn = [random_tokens(g, 32, vocab) for _ in range(3)]
    engine = inf_engine(
        model, "fp32", max_seq_len=1024, kv_block_size=16,
        kv_pool_blocks=6, host_tier=tier_block("p13-fault",
                                               lazy_alloc=False),
        extra={"resilience": {"fault_injection": {"enabled": True,
               "faults": [{"site": "host_tier.copy", "times": 1,
                           "args": {"mode": "oserror"}}]}}})
    try:
        first = engine.generate([template], max_new_tokens=8)[0]
        run_requests(engine, churn, 8)
        misses = engine.metrics.counter("infer/prefix_misses").value
        second = engine.generate([template], max_new_tokens=8)[0]
        counts = tier_counts(engine)
        cold = engine.metrics.counter("infer/prefix_misses").value - misses
    finally:
        engine.close()
    if counts["copy_faults"] != 1:
        fail(f"13b fault: copy_faults {counts['copy_faults']} != 1")
    if second != first or cold != 1 or counts["promotions"] != 0:
        fail(f"13b fault: the template did not serve cold and equal "
             f"(cold {cold}, {counts})")
    return {"counts": counts, "second_serve_cold": True}


def spec_models(seed):
    """The GPT-2 small target with blocks 3-12's attn_ow/output_w and
    biases zeroed (they add 0.0 to the residual stream, at full cost), the
    agreeing draft (the target's first 2 blocks, embeddings and ln_f) and
    an independent random 2-layer draft."""
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    target = GPT2LMHeadModel(GPT2Config.small(), device="cuda", seed=seed)
    with torch.no_grad():
        for layer in target.h[2:]:
            for name in ("attn_ow", "output_w", "attn_ob", "output_b"):
                getattr(layer, name).zero_()
    dcfg = GPT2Config.small(n_layer=2)
    agreeing = GPT2LMHeadModel(dcfg, device="cuda", seed=seed)
    agreeing.load_state_dict({k: v for k, v in target.state_dict().items()
                              if not k.startswith("h.")
                              or int(k.split(".")[1]) < 2})
    independent = GPT2LMHeadModel(dcfg, device="cuda", seed=seed + 1)
    return target, {"agreeing": agreeing, "independent": independent}


def spec_stats(engine, st):
    """A speculative run's numbers. ``tokens_per_target_step``: tokens one
    slot commits a verify step (the accepted proposals plus the target's
    own token), 1 + k * acceptance."""
    snap = engine.metrics.snapshot()
    slot_steps = snap["infer/spec_proposed"] / SPEC_K
    return {
        "ttft_ms_mean": st["ttft_ms_mean"],
        "decode_tokens_per_s": decode_rate(st),
        "decode_steps": st["decode_steps"],
        "tokens_per_target_step": (
            (snap["infer/spec_accepted"] + slot_steps) / max(1, slot_steps)),
        "acceptance": snap["infer/spec_acceptance_rate"],
        "proposed": snap["infer/spec_proposed"],
        "accepted": snap["infer/spec_accepted"],
        "cold_prefills": st["cold_prefills"],
        "requests": st["requests"],
    }


def phase_spec(seed, card, vocab):
    """Phase 13c. Returns (launches, stats)."""
    target, drafts = spec_models(seed)
    g = torch.Generator().manual_seed(seed + 136)
    prompts = [random_tokens(g, n, vocab) for n in SPEC_LENGTHS]
    paged = dict(max_seq_len=SPEC_MAX_SEQ, kv_block_size=16)
    spec = dict(paged, speculative={"k": SPEC_K})
    log(f"phase 13c: speculative (k={SPEC_K}), float32: tokens vs the "
        f"non-speculative engine")
    e = inf_engine(target, "fp32", fused_decode=True, **paged)
    out_ref, _ = run_requests(e, prompts, SPEC_NEW)
    e.close()
    for name, draft in drafts.items():
        e = inf_engine(target, "fp32", draft=draft, **spec)
        out, st = run_requests(e, prompts, SPEC_NEW)
        s = spec_stats(e, st)
        e.close()
        same_tokens(f"13c {name} draft (fp32)", prompts, out, out_ref,
                    target, vocab)
        log(f"  {name} draft: spec == non-spec; acceptance "
            f"{s['acceptance']:.4f}, {s['tokens_per_target_step']:.3f} "
            f"tokens a target step")
    torch.cuda.empty_cache()

    log("phase 13c: bf16 (the measured path)")
    ref = inf_engine(target, "bf16", fused_decode=True, **paged)
    run_requests(ref, prompts[:1], 4)
    out_refb, st_ref = run_requests(ref, prompts, SPEC_NEW)
    bf16_target = ref.model
    stats = {"non_speculative": {
        "ttft_ms_mean": st_ref["ttft_ms_mean"],
        "decode_tokens_per_s": decode_rate(st_ref),
        "decode_steps": st_ref["decode_steps"]}}
    warm = inf_engine(target, "bf16", draft=drafts["agreeing"], **spec)
    run_requests(warm, prompts[:1], 4)
    warm.close()
    zero_launches()
    per_draft = {}
    for name, draft in drafts.items():
        before = read_launches()
        e = inf_engine(target, "bf16", draft=draft, **spec)
        out, st = run_requests(e, prompts, SPEC_NEW)
        s = spec_stats(e, st)
        e.close()
        after = read_launches()
        flash = after["flash_fwd"] - before["flash_fwd"]
        s["draft_flash_fwd_per_prefill"] = (
            flash - N_LAYER * s["cold_prefills"]) / s["requests"]
        if s["draft_flash_fwd_per_prefill"] != 2:
            fail(f"13c {name}: flash_fwd {flash} for {s['cold_prefills']} "
                 f"target prefills and {s['requests']} draft prefills: the "
                 "draft's is not 2 a prefill")
        s["bf16_divergence"] = bf16_divergence(
            f"13c {name} draft vs non-spec", prompts, out, out_refb,
            bf16_target, vocab)
        s["speedup_vs_non_speculative"] = (
            s["decode_tokens_per_s"] / decode_rate(st_ref))
        per_draft[name] = s
        log(f"  {name} draft bf16: acceptance {s['acceptance']:.4f}, "
            f"{s['tokens_per_target_step']:.3f} tokens a target step, "
            f"decode {s['decode_tokens_per_s']:.1f} tokens/s vs "
            f"{decode_rate(st_ref):.1f} non-speculative on {card}")
    launches = read_launches()
    ref.close()
    check_window("13c spec", launches, ("flash_fwd",),
                 ("paged_decode", "sgmv", "flash_bwd_dq"))
    stats.update(per_draft)
    return launches, stats


def phase_inference_rest(seed, card):
    """Phase 13. Returns ({path: launches}, stats)."""
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    cfg = GPT2Config.small()
    model = GPT2LMHeadModel(cfg, device="cuda", seed=seed)
    model.requires_grad_(False)
    vocab = cfg.vocab_size
    t0 = time.monotonic()
    launches, stats = {}, {"card": card}
    launches["contig"], stats["contig"] = phase_contig(seed, card, model,
                                                       vocab)
    torch.cuda.empty_cache()
    launches["host_tier"], stats["host_tier"] = phase_tier(seed, card, model,
                                                           vocab)
    del model
    torch.cuda.empty_cache()
    launches["spec"], stats["spec"] = phase_spec(seed, card, vocab)
    torch.cuda.empty_cache()
    stats["wall_s"] = time.monotonic() - t0
    log(f"phase 13: {stats['wall_s']:.1f} s")
    return launches, stats


# ---------------------------------------------------------------------------
# phase 14: data parallel (ZeRO stages 0-3, checkpoints across dp)
# ---------------------------------------------------------------------------
P14_ROWS, P14_MICRO, P14_DP = 8, 4, 2
# (name, optimizer, precision, ZeRO stage, windows)
# the windows of each run of phases 14b and 15b and of their dp = 1
# references (3 before phase 17 came; 2 since, to keep the script in its
# time limit)
P14_WINDOWS = 2
# the depth of those runs and references (12 before phase 18 came, 6
# before phase 20; 4 since, to keep the script in its time limit); phase
# 14a keeps GPT-2 small's 12
P14_LAYERS = 4
P14_RUNS = (
    [(f"adam-fp32-s{st}", "Adam", "fp32", st, P14_WINDOWS)
     for st in range(4)]
    + [(f"adam-bf16-s{st}", "Adam", "bf16", st, P14_WINDOWS)
       for st in range(4)]
    + [(f"fusedlamb-bf16-s{st}", "FusedLamb", "bf16", st, P14_WINDOWS)
       for st in (1, 3)])
P14_SAVE = "adam-fp32-s1"
P14_RTOL = 2e-4


def p14_config(optimizer, precision, stage, micro, dp, extra=None):
    cfg = {"train_batch_size": micro * dp,
           "train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": 1,
           "optimizer": {"type": optimizer, "params": {"lr": 1e-4}},
           "zero_optimization": {"stage": stage},
           "gradient_clipping": 1.0, "steps_per_print": 1000}
    if precision == "bf16":
        cfg["bf16"] = {"enabled": True}
    cfg.update(extra or {})
    return cfg


def p14_rows(seed):
    """The global batch: 8 x 1024 token ids from ``seed``."""
    from deepspeed_tpu_torch import GPT2Config

    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, GPT2Config.small().vocab_size, (P14_ROWS, 1024),
                         generator=g)


def p14_fingerprint(engine, seed, rank, dp):
    """The eval loss of a fixed 8-row batch, averaged over the ranks."""
    import torch.distributed as dist

    ids = p14_rows(seed + 1)
    per = P14_ROWS // dp
    mine = ids[rank * per:(rank + 1) * per].cuda()
    engine.eval()
    with torch.no_grad():
        loss = engine(mine, mine).detach().float().clone()
    engine.train()
    if dp > 1:
        dist.all_reduce(loss)
    return float(loss) / dp


def p14_expected_zero3_bytes(model, dp, itemsize):
    """The stage-3 accounting from the shapes alone: a tensor with a dim
    dp divides keeps 1/dp of its bytes and moves (dp-1)/dp of them twice
    a window (forward gather, backward re-gather); any other stays
    whole."""
    resident = gather = 0
    for p in model.parameters():
        nbytes = p.numel() * itemsize
        if any(d % dp == 0 for d in p.shape):
            resident += nbytes // dp
            gather += 2 * (nbytes * (dp - 1) // dp)
        else:
            resident += nbytes
    return resident, gather


def p14_train(name, optimizer, precision, stage, windows, seed, rank, dp,
              micro, extra=None, model_kw=None):
    """One run of GPT-2 small through initialize() on this rank's rows
    (``extra``: more config blocks; ``model_kw``: GPT2Config fields):
    losses, launches, memory (after init, and the peak of the windows),
    the stage-3 gauges and their accounting; the engine is returned."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    gc.collect()  # the last run's engine, before the memory is read
    torch.cuda.empty_cache()
    model = GPT2LMHeadModel(GPT2Config.small(dropout=0.0, n_layer=P14_LAYERS,
                                             **(model_kw or {})),
                            device="cuda", seed=seed)
    # from the full shapes, before stage 3 shards the module
    itemsize = 2 if precision == "bf16" else 4
    expected = (list(p14_expected_zero3_bytes(model, dp, itemsize))
                if stage == 3 and dp > 1 else [0, 0])
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model,
        config_params=p14_config(optimizer, precision, stage, micro, dp,
                                 extra))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rows = p14_rows(seed)[rank * micro:(rank + 1) * micro].cuda()
    zero_launches()
    t0 = time.monotonic()
    losses = [float(engine.train_batch(iter([(rows, rows)])))
              for _ in range(windows)]
    torch.cuda.synchronize()
    out = {"losses": losses, "launches": read_launches(),
           "window_s": (time.monotonic() - t0) / windows,
           "held_gb": held / 1e9,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "skipped": engine.skipped_steps,
           "zero3_bytes": [engine._zero3_shard_bytes,
                           engine._zero3_gather_bytes]}
    out["zero3_expected"] = expected
    return engine, model, out


def phase14_rank(spec_path):
    """One of phase 14's two ranks (a subprocess): joins the gloo group the
    phase made, runs every P14_RUNS entry, saves the P14_SAVE checkpoint
    with its fingerprint, and writes its results as JSON."""
    import torch.distributed as dist

    spec = json.loads(Path(spec_path).read_text())
    rank = spec["rank"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the group initialize() finds and uses as it is
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{spec['port']}", rank=rank,
        world_size=P14_DP)
    results = {}
    for name, optimizer, precision, stage, windows in P14_RUNS:
        engine, model, out = p14_train(name, optimizer, precision, stage,
                                       windows, spec["seed"], rank, P14_DP,
                                       P14_MICRO)
        if name == P14_SAVE:
            engine.save_checkpoint(spec["ckpt"], tag="dp2")
            out["fingerprint"] = p14_fingerprint(engine, spec["seed"], rank,
                                                 P14_DP)
        results[name] = out
        del engine, model
    Path(spec["out"]).write_text(json.dumps(results))
    dist.barrier()
    dist.destroy_process_group()


def p14_nccl_world1(seed):
    """(a) The DS_TPU_* environment at world size 1 reaches
    init_distributed through initialize(): an NCCL group; the port's
    collectives on CUDA tensors through it, and GPT-2 small trains 3
    windows at stage 2."""
    import socket

    import torch.distributed as dist

    from deepspeed_tpu_torch.runtime import dist as dist_lib

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {dist_lib.COORD_ENV: f"localhost:{port}", dist_lib.NPROC_ENV: "1",
           dist_lib.PID_ENV: "0"}
    os.environ.update(env)
    try:
        import deepspeed_tpu_torch
        from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

        model = GPT2LMHeadModel(GPT2Config.small(dropout=0.0), device="cuda",
                                seed=seed)
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=model, dist_init_required=True,
            config_params=p14_config("Adam", "bf16", 2, P14_ROWS, 1))
        backend = dist.get_backend()
        if backend != "nccl":
            fail(f"phase 14a: the DS_TPU_* bootstrap made a {backend} group")
        x = torch.full((8,), 3.0, device="cuda")
        dist_lib.all_reduce(x)
        rs = torch.empty(8, device="cuda")
        dist_lib.reduce_scatter(rs, torch.arange(8.0, device="cuda"))
        ag = torch.empty(8, device="cuda")
        dist_lib.all_gather(ag, torch.arange(8.0, device="cuda"),
                            async_op=True).wait()
        want = torch.arange(8.0, device="cuda")
        if not (x.eq(3.0).all() and torch.equal(rs, want)
                and torch.equal(ag, want)):
            fail("phase 14a: NCCL collectives at world size 1 changed "
                 "their input")
        rows = p14_rows(seed).cuda()
        zero_launches()
        losses = [float(engine.train_batch(iter([(rows, rows)])))
                  for _ in range(3)]
        launches = read_launches()
        if not all(math.isfinite(v) for v in losses):
            fail(f"phase 14a: losses {losses}")
        check_launches("phase 14a", launches, 3)
        log(f"  14a: NCCL world size 1 ({backend}); stage-2 losses {losses}")
        del engine, model
        return launches, {"backend": backend, "losses": losses}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
        torch.cuda.empty_cache()


def p14_spawn(seed, root, timeout_s=420, flag="--phase14-rank",
              phase="14b", world=P14_DP):
    """(b) Two ranks on the one card: NCCL refuses two ranks on one device
    ("Duplicate GPU detected"), so the ranks join a gloo group this phase
    makes (gloo takes the port's collectives on CUDA tensors). The kernels
    are built already (phase 2), so the ranks
    load them from the cache. Fails if a rank fails or outlives
    ``timeout_s``; returns every rank's results."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(world):
        spec = root / f"rank{rank}.json"
        spec.write_text(json.dumps({
            "rank": rank, "port": port, "seed": seed,
            "ckpt": str(root / "ckpt"), "out": str(root / f"out{rank}.json")}))
        log_file = open(root / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), flag,
             str(spec)],
            stdout=log_file, stderr=subprocess.STDOUT), log_file))
    deadline = time.monotonic() + timeout_s
    failed = []
    for rank, (proc, log_file) in enumerate(procs):
        try:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for other, _ in procs:
                other.kill()
            proc.wait()
            failed.append(f"rank {rank} hung past {timeout_s} s")
        log_file.close()
        if proc.returncode != 0 and not failed:
            failed.append(f"rank {rank} exited {proc.returncode}")
    if failed:
        for rank in range(world):
            tail = (root / f"rank{rank}.log").read_text()[-3000:]
            log(f"--- phase {phase} rank {rank} log tail ---\n{tail}")
        fail(f"phase {phase}: {failed}")
    return [json.loads((root / f"out{r}.json").read_text())
            for r in range(world)]


def p14_close(tag, got, want):
    ok = all(math.isclose(a, b, rel_tol=P14_RTOL)
             for a, b in zip(got, want)) and len(got) == len(want)
    if not ok:
        fail(f"phase 14: {tag}: {got} != {want} (rtol {P14_RTOL})")


def phase_data_parallel(seed, card):
    """Phase 14. Returns ({kernel: {path: launches}}, stats)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    t0 = time.monotonic()
    stats = {"card": card}
    launches = {name: {} for name in launch_counters()}
    a_launches, stats["nccl_world1"] = p14_nccl_world1(seed)
    for name, n in a_launches.items():
        launches[name]["dp_nccl1"] = n
    root = Path("build") / "phase14"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ranks = p14_spawn(seed, root)
    # the dp = 1 run over the same 8 rows (micro-batch 8), float32 Adam
    engine, model, ref = p14_train("dp1", "Adam", "fp32", 0, P14_WINDOWS,
                                   seed, 0, 1, P14_ROWS)
    del engine, model
    torch.cuda.empty_cache()
    runs = {}
    for name, optimizer, precision, stage, windows in P14_RUNS:
        per_rank = [r[name] for r in ranks]
        losses = per_rank[0]["losses"]
        for r in per_rank[1:]:
            if r["losses"] != losses:
                fail(f"phase 14: {name}: ranks return different losses")
        if not all(math.isfinite(v) for v in losses) or per_rank[0][
                "skipped"]:
            fail(f"phase 14: {name}: losses {losses}")
        if precision == "bf16" and not losses[-1] < losses[0]:
            fail(f"phase 14: {name}: bf16 losses do not fall: {losses}")
        for rank, r in enumerate(per_rank):
            got = r["launches"]
            for k in TRAIN_KERNELS:
                if got[k] != P14_LAYERS * windows:
                    fail(f"phase 14: {name} rank {rank}: {k} launched "
                         f"{got[k]} times, want {P14_LAYERS * windows}")
            if optimizer == "FusedLamb" and got["lamb_phase1"] < windows:
                fail(f"phase 14: {name} rank {rank}: lamb_phase1 launched "
                     f"{got['lamb_phase1']} times on the shards")
            if r["zero3_bytes"] != r["zero3_expected"]:
                fail(f"phase 14: {name}: stage-3 gauges {r['zero3_bytes']} "
                     f"!= the accounting {r['zero3_expected']}")
            for k, n in got.items():
                path = f"dp2_rank{rank}"
                launches[k][path] = launches[k].get(path, 0) + n
        runs[name] = {
            "losses": losses,
            "window_s": [r["window_s"] for r in per_rank],
            "held_gb": [r["held_gb"] for r in per_rank],
            "peak_gb": [r["peak_gb"] for r in per_rank],
            "zero3_bytes": per_rank[0]["zero3_bytes"]}
        log(f"  {name}: losses {losses}; held GB {runs[name]['held_gb']}, "
            f"peak GB {runs[name]['peak_gb']}, s/window "
            f"{runs[name]['window_s']}")
    base = runs["adam-fp32-s0"]["losses"]
    for st in (1, 2, 3):
        p14_close(f"float32 stage {st} vs stage 0",
                  runs[f"adam-fp32-s{st}"]["losses"], base)
    p14_close("dp 2 vs dp 1 on the same 8 rows", base, ref["losses"])
    # a dp = 2 checkpoint loads at dp = 1 with an equal fingerprint
    model = GPT2LMHeadModel(GPT2Config.small(dropout=0.0, n_layer=P14_LAYERS),
                            device="cuda", seed=seed + 7)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config_params=p14_config("Adam", "fp32", 1, P14_ROWS,
                                              1))
    path, _ = engine.load_checkpoint(str(root / "ckpt"))
    fp1 = p14_fingerprint(engine, seed, 0, 1)
    fp2 = ranks[0][P14_SAVE]["fingerprint"]
    if path is None or not math.isclose(fp1, fp2, rel_tol=1e-5):
        fail(f"phase 14: the dp 2 checkpoint at dp 1: fingerprint {fp1} "
             f"!= {fp2}")
    shards = sorted(f.name for f in (root / "ckpt" / "dp2").iterdir()
                    if f.name.startswith("zero_pp_rank_"))
    if len(shards) != P14_DP:
        fail(f"phase 14: optimizer shard files {shards}")
    del engine, model
    torch.cuda.empty_cache()
    stats.update(runs=runs, dp1_losses=ref["losses"],
                 dp1_peak_gb=ref["peak_gb"], dp1_held_gb=ref["held_gb"],
                 fingerprint_dp2=fp2, fingerprint_dp1=fp1,
                 wall_s=time.monotonic() - t0)
    log(f"phase 14: {stats['wall_s']:.1f} s")
    return launches, stats


# ---------------------------------------------------------------------------
# phase 15: the launcher, and what the engine took over from the JAX one
# ---------------------------------------------------------------------------
P15_LAUNCH_WINDOWS = 2
P15_Z3G = "nothing_saveable+zero3_gathered"
P15_COMPENSATED = {"data_types": {"master_dtype": "compensated"}}
P15_ADAPTERS = {"adapters": {"enabled": True, "rank": LORA_RANK}}
# (name, optimizer, precision, stage, windows, config blocks, GPT2Config
# fields, the dp = 1 run it must equal)
P15_RUNS = (
    [(f"compensated-bf16-s{st}", "Adam", "bf16", st, P14_WINDOWS,
      P15_COMPENSATED, {}, "compensated") for st in (1, 2)]
    + [(f"adapters-fp32-s{st}", "Adam", "fp32", st, P14_WINDOWS,
        P15_ADAPTERS, {}, "adapters") for st in range(4)]
    + [(f"remat-{p}-s3", "Adam", "fp32", 3, P14_WINDOWS, {},
        {"remat": True, "remat_policy": p}, "remat")
       for p in ("full", P15_Z3G)])
# the dp = 1 runs over the same 8 rows: (precision, config, model fields)
P15_REFS = {"compensated": ("bf16", P15_COMPENSATED, {}),
            "adapters": ("fp32", P15_ADAPTERS, {}),
            "remat": ("fp32", {}, {"remat": True})}


def phase15_launched_rank(argv):
    """Phase 15a's rank, started by the port's runner: its arguments
    through add_config_arguments, initialize(args=...) over the
    launcher's environment, bound to cuda:<LOCAL_RANK> in an NCCL group;
    GPT-2 small trains P15_LAUNCH_WINDOWS windows. Writes its results as
    JSON, or exits with the spec's code at once."""
    import torch.distributed as dist

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    parser = argparse.ArgumentParser()
    parser.add_argument("--phase15-rank", dest="spec", required=True)
    args = deepspeed_tpu_torch.add_config_arguments(parser).parse_args(argv)
    spec = json.loads(Path(args.spec).read_text())
    if spec.get("exit"):
        sys.exit(spec["exit"])
    cfg = GPT2Config.small(dropout=DROPOUT)
    model = GPT2LMHeadModel(cfg, device="cuda", seed=spec["seed"])
    engine, *_ = deepspeed_tpu_torch.initialize(
        args=args, model=model, dist_init_required=True)
    micro = train_batches(spec["seed"], cfg.vocab_size)
    zero_launches()
    losses, secs, _ = run_windows(engine, micro, P15_LAUNCH_WINDOWS)
    out = {"losses": losses, "window_s": secs, "launches": read_launches(),
           "backend": dist.get_backend(), "world": dist.get_world_size(),
           "device": torch.cuda.current_device(),
           "env": {k: os.environ.get(k) for k in (
               "LOCAL_RANK", "RANK", "WORLD_SIZE", "CUDA_VISIBLE_DEVICES",
               "DS_TPU_PROCESS_ID", "DS_TPU_NUM_PROCESSES")},
           "zero_stage": engine.zero_stage,
           "global_steps": engine.global_steps,
           "skipped_steps": engine.skipped_steps}
    Path(spec["out"]).write_text(json.dumps(out))
    dist.destroy_process_group()


def p15_launch(root, seed, spec_extra, timeout_s=300):
    """``python -m deepspeed_tpu_torch.launcher.runner --num_gpus 1`` over
    this script's phase 15a rank; returns (exit code, seconds, the rank's
    results or None)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    tag = "fail" if spec_extra.get("exit") else "train"
    spec = root / f"{tag}.json"
    out = root / f"{tag}_out.json"
    spec.write_text(json.dumps({"seed": seed, "out": str(out),
                                **spec_extra}))
    ds_config = root / "ds_config.json"
    ds_config.write_text(json.dumps(dict(
        train_config("FusedLamb", 1e-3, BF16),
        zero_optimization={"stage": 2})))
    checkout = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner",
           "--hostfile", str(root / "no_hostfile"), "--num_gpus", "1",
           "--master_port", str(port), str(checkout / "chip_smoke.py"),
           "--phase15-rank", str(spec), "--deepspeed", "--deepspeed_config",
           str(ds_config)]
    t0 = time.monotonic()
    with open(root / f"{tag}.log", "w") as log_file:
        proc = subprocess.Popen(cmd, cwd=str(checkout), stdout=log_file,
                                stderr=subprocess.STDOUT)
        try:
            rc = proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            log((root / f"{tag}.log").read_text()[-3000:])
            fail(f"phase 15a: the runner ({tag}) outlived {timeout_s} s")
    secs = time.monotonic() - t0
    if rc != spec_extra.get("exit", 0) or (tag == "train"
                                           and not out.exists()):
        log((root / f"{tag}.log").read_text()[-3000:])
    return rc, secs, (json.loads(out.read_text()) if out.exists() else None)


def phase15_launcher(seed, root):
    """(a) The launcher on the card: one rank through the port's runner
    (NCCL on cuda:0 from LOCAL_RANK; GPT-2 small, bf16, FusedLamb, ZeRO
    stage 2, P15_LAUNCH_WINDOWS windows), then a rank that exits 3 on
    purpose: the runner must exit 3."""
    rc, secs, got = p15_launch(root, seed, {})
    if rc != 0 or got is None:
        fail(f"phase 15a: the launched run exited {rc}")
    env = got["env"]
    if (got["backend"] != "nccl" or got["device"] != 0 or got["world"] != 1
            or env["LOCAL_RANK"] != "0" or env["RANK"] != "0"
            or env["WORLD_SIZE"] != "1"):
        fail(f"phase 15a: the launched rank is {got['backend']} on cuda:"
             f"{got['device']} with {env}")
    if not all(math.isfinite(v) for v in got["losses"]) or got[
            "skipped_steps"]:
        fail(f"phase 15a: losses {got['losses']}, skipped "
             f"{got['skipped_steps']}")
    # as phase 14a: 12 launches of each attention kernel a micro-step, and
    # FusedLamb's 6 a step (at world size 1 stage 2 is stage 0)
    check_launches("phase 15a", got["launches"], 2 * P15_LAUNCH_WINDOWS,
                   lamb_steps=P15_LAUNCH_WINDOWS)
    fail_rc, fail_secs, _ = p15_launch(root, seed, {"exit": 3})
    if fail_rc != 3:
        fail(f"phase 15a: a rank exited 3 and the runner exited {fail_rc}")
    log(f"  15a: launched rank {got['backend']} on cuda:{got['device']} "
        f"(env {env}); losses {got['losses']}; runner {secs:.1f} s; the "
        f"failing launch exited {fail_rc} in {fail_secs:.1f} s")
    return got["launches"], {
        "losses": got["losses"], "window_s": got["window_s"],
        "env": env, "backend": got["backend"], "runner_s": secs,
        "fail_rc": fail_rc, "fail_s": fail_secs}


def phase15b_rank(spec_path):
    """One of phase 15b's two ranks (a subprocess): joins the gloo group
    the phase made and runs every P15_RUNS entry."""
    import torch.distributed as dist

    spec = json.loads(Path(spec_path).read_text())
    rank = spec["rank"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{spec['port']}", rank=rank,
        world_size=P14_DP)
    results = {}
    for name, optimizer, precision, stage, windows, extra, mkw, _ in P15_RUNS:
        engine, model, out = p14_train(name, optimizer, precision, stage,
                                       windows, spec["seed"], rank, P14_DP,
                                       P14_MICRO, extra, mkw)
        out["zero3_armed"] = engine.zero3_gather_enabled
        out["trainable"] = sum(p.numel() for p in engine.params.values())
        results[name] = out
        del engine, model
    Path(spec["out"]).write_text(json.dumps(results))
    dist.barrier()
    dist.destroy_process_group()


def phase15_refusals_dp2(seed, root):
    """(b) Compensated masters (bf16, stages 1-2), the adapters block
    (rank 16, stages 0-3) and stage 3 under remat "full" and
    P15_Z3G, on two gloo ranks sharing the card (phase 14b's spawn): each
    equals its dp = 1 run over the same 8 rows at P14_RTOL; the tagged
    stage-3 run equals "full"'s. Returns ({kernel: {path: n}}, stats)."""
    ranks = p14_spawn(seed, root, flag="--phase15b-rank", phase="15b")
    refs = {}
    for key, (precision, extra, mkw) in P15_REFS.items():
        engine, model, refs[key] = p14_train(
            f"dp1-{key}", "Adam", precision, 0, P14_WINDOWS, seed, 0, 1,
            P14_ROWS, extra, mkw)
        del engine, model
        torch.cuda.empty_cache()
    launches, runs = {}, {}
    for name, _, precision, stage, windows, extra, mkw, ref in P15_RUNS:
        per_rank = [r[name] for r in ranks]
        losses = per_rank[0]["losses"]
        if any(r["losses"] != losses for r in per_rank[1:]):
            fail(f"phase 15b: {name}: ranks return different losses")
        if not all(math.isfinite(v) for v in losses) or per_rank[0][
                "skipped"]:
            fail(f"phase 15b: {name}: losses {losses}")
        p14_close(f"15b {name} vs its dp = 1 run", losses,
                  refs[ref]["losses"])
        # under remat at stage 3 the gather block is the checkpointed
        # region, so the backward runs the flash forward again
        want = {k: P14_LAYERS * windows for k in TRAIN_KERNELS}
        if mkw.get("remat"):
            want["flash_fwd"] *= 2
        for rank, r in enumerate(per_rank):
            for k in TRAIN_KERNELS:
                if r["launches"][k] != want[k]:
                    fail(f"phase 15b: {name} rank {rank}: {k} launched "
                         f"{r['launches'][k]} times, want {want[k]}")
            for k, n in r["launches"].items():
                by_path = launches.setdefault(k, {})
                path = f"a6b_dp2_rank{rank}"
                by_path[path] = by_path.get(path, 0) + n
        runs[name] = {"losses": losses,
                      "window_s": [r["window_s"] for r in per_rank],
                      "peak_gb": [r["peak_gb"] for r in per_rank],
                      "held_gb": [r["held_gb"] for r in per_rank],
                      "zero3_armed": per_rank[0]["zero3_armed"],
                      "trainable_per_rank": per_rank[0]["trainable"]}
        log(f"  15b {name}: losses {losses} (dp 1: {refs[ref]['losses']}); "
            f"held GB {runs[name]['held_gb']}, peak GB "
            f"{runs[name]['peak_gb']}")
    tagged = runs[f"remat-{P15_Z3G}-s3"]
    if not (tagged["zero3_armed"] and runs["remat-full-s3"]["zero3_armed"]):
        fail("phase 15b: the stage-3 gather stack was not armed")
    bitwise = tagged["losses"] == runs["remat-full-s3"]["losses"]
    p14_close("15b zero3_gathered vs full", tagged["losses"],
              runs["remat-full-s3"]["losses"])
    return launches, {"runs": runs,
                      "dp1": {k: {"losses": v["losses"],
                                  "peak_gb": v["peak_gb"]}
                              for k, v in refs.items()},
                      "zero3_gathered_bitwise_full": bitwise}


def p15_bert_lora_batch(seed, vocab, seq):
    """8 rows of BERT_LENGTHS at ``seq``: ids in the valid positions, two
    segments, 15% masked-LM labels and NSP labels, on the card."""
    g = torch.Generator().manual_seed(seed)
    mask = bert_mask("cpu", BERT_LENGTHS, seq)
    valid = mask > 0
    ids = torch.where(valid, torch.randint(1, vocab, (len(BERT_LENGTHS), seq),
                                           generator=g), 0)
    tt = (torch.arange(seq)[None, :] >= seq // 2).long() * valid
    pick = (torch.rand(ids.shape, generator=g) < 0.15) & valid
    labels = torch.where(pick, ids, -100)
    nsp = torch.randint(0, 2, (len(BERT_LENGTHS),), generator=g)
    return tuple(t.cuda() for t in (ids, mask, tt, labels, nsp))


def p15_grads(model, batch, plain, names=None):
    """The loss and float32 gradients of ``model`` on ``batch`` (train
    mode, no dropout seed), through the kernels or their plain versions;
    only the parameters in ``names`` when given, none for an empty set
    (the forward alone)."""
    from deepspeed_tpu_torch.ops import attention as A

    params = [p for n, p in model.named_parameters()
              if names is None or n in names]
    kernels = (A.flash_fwd, A.flash_bwd_dq, A.flash_bwd_dkv)
    if plain:
        A.flash_fwd, A.flash_bwd_dq, A.flash_bwd_dkv = (
            plain_flash_fwd, A.flash_bwd_dq_plain, A.flash_bwd_dkv_plain)
    try:
        with torch.set_grad_enabled(bool(params)):
            loss = model(*batch, train=True)
        if not params:
            return float(loss), []
        return float(loss.detach()), [
            g.float() for g in torch.autograd.grad(loss, params)]
    finally:
        A.flash_fwd, A.flash_bwd_dq, A.flash_bwd_dkv = kernels


def phase15_one_process(seed):
    """(c) BERT-large with LoRA factors (rank 16) and without flash, and
    GPT-2 small's stochastic_mode. Returns ({kernel: {path: n}}, stats)."""
    import dataclasses

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import (BertConfig, BertForPreTraining,
                                     GPT2Config, GPT2LMHeadModel)
    from deepspeed_tpu_torch.ops import transformer as T

    launches, stats = {}, {}
    # BERT-large with the model's own LoRA factors, float32, one
    # micro-step at seq 512 through the kernels and through the plain
    # versions
    cfg = BertConfig.bert_large(hidden_dropout_prob=0.0,
                                attention_probs_dropout_prob=0.0,
                                lora_rank=LORA_RANK, lora_alpha=32.0)
    model = BertForPreTraining(cfg, device="cuda", seed=seed)
    with torch.no_grad():  # B = 0 at init: give both factors a gradient
        g = torch.Generator(device="cuda").manual_seed(seed + 3)
        for n, p in model.named_parameters():
            if n.endswith("_lora_b"):
                p.normal_(0.0, 0.02, generator=g)
    factors = {n for n, _ in model.named_parameters() if "_lora_" in n}
    if len(factors) != 2 * 4 * cfg.num_hidden_layers:
        fail(f"phase 15c: BERT-large carries {len(factors)} LoRA factors")
    batch = p15_bert_lora_batch(seed, cfg.vocab_size, BERT_SEQ)
    zero_launches()
    loss_k, got = p15_grads(model, batch, False, factors)
    torch.cuda.synchronize()
    lora_launches = read_launches()
    loss_p, want = p15_grads(model, batch, True, factors)
    err = max(float((a - w).abs().max() / w.abs().max().clamp_min(1e-30))
              for a, w in zip(got, want))
    log(f"  15c BERT-large LoRA rank {LORA_RANK}: loss kernels {loss_k} "
        f"plain {loss_p}; factor gradients max|diff| / max|plain| "
        f"{err:.3e} (tol {TOL[torch.float32]:g}); launches {lora_launches}")
    if err > TOL[torch.float32]:
        fail("phase 15c: BERT LoRA factor gradients through the kernels "
             "disagree with the plain versions'")
    if any(lora_launches[k] != cfg.num_hidden_layers for k in TRAIN_KERNELS):
        fail(f"phase 15c: BERT LoRA launches {lora_launches}, want "
             f"{cfg.num_hidden_layers} each a micro-step")
    stats["bert_lora"] = {"loss_kernels": loss_k, "loss_plain": loss_p,
                          "factor_grad_err": err,
                          "factors": len(factors)}
    for k, n in lora_launches.items():
        launches.setdefault(k, {})["bert_lora"] = n
    del model, got, want
    torch.cuda.empty_cache()

    # BERT-large with use_flash=False: no flash launch; its loss equals
    # the flash route's through the plain versions on the same batch
    base_cfg = BertConfig.bert_large(hidden_dropout_prob=0.0,
                                     attention_probs_dropout_prob=0.0)
    micro = bert_batches(seed, base_cfg, BERT_SEQ, "pretraining",
                         accum=1)[0]
    losses = {}
    for use_flash in (False, True):
        model = BertForPreTraining(
            dataclasses.replace(base_cfg, use_flash=use_flash),
            device="cuda", seed=seed)
        zero_launches()
        if use_flash:
            losses["plain"], _ = p15_grads(model, micro, True, set())
        else:
            losses["no_flash"], _ = p15_grads(model, micro, False, set())
            noflash_launches = read_launches()
        del model
        torch.cuda.empty_cache()
    log(f"  15c BERT-large use_flash=False: loss {losses['no_flash']} vs "
        f"the plain versions' {losses['plain']}; launches {noflash_launches}")
    if any(noflash_launches[k] for k in TRAIN_KERNELS):
        fail(f"phase 15c: use_flash=False launched {noflash_launches}")
    if not math.isclose(losses["no_flash"], losses["plain"],
                        rel_tol=LAMB_RTOL):
        fail(f"phase 15c: use_flash=False loss {losses['no_flash']} != "
             f"{losses['plain']}")
    stats["bert_no_flash"] = losses
    for k, n in noflash_launches.items():
        launches.setdefault(k, {})["bert_no_flash"] = n

    # GPT-2 small with stochastic_mode in bf16: trains, and its LayerNorm
    # output differs from the default path's
    gcfg = GPT2Config.small(dropout=DROPOUT)
    model = GPT2LMHeadModel(gcfg, device="cuda", seed=seed)
    model.layer_config.stochastic_mode = True
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config_params=train_config("Adam", 1e-4, BF16))
    micro = train_batches(seed, gcfg.vocab_size)
    zero_launches()
    losses, secs, _ = run_windows(engine, micro, 3)
    st_launches = read_launches()
    if not all(math.isfinite(v) for v in losses) or engine.skipped_steps:
        fail(f"phase 15c: stochastic_mode losses {losses}")
    check_launches("phase 15c stochastic_mode", st_launches, 6)
    x = (torch.randn(8, 1024, 768, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(
                         seed)) * 3 + 1).to(torch.bfloat16)
    w = torch.ones(768, device="cuda")
    b = torch.zeros(768, device="cuda")
    relaxed = T.layer_norm_apply(model.layer_config, x, w, b)
    default = T.layer_norm_apply(
        dataclasses.replace(model.layer_config, stochastic_mode=False),
        x, w, b)
    differ = float((relaxed.float() - default.float()).abs().max())
    if differ == 0.0:
        fail("phase 15c: stochastic_mode's LayerNorm equals the default's")
    log(f"  15c stochastic_mode: losses {losses}; LayerNorm max|relaxed - "
        f"default| {differ:.3e}")
    stats["stochastic"] = {"losses": losses, "window_s": secs,
                           "layer_norm_max_diff": differ}
    for k, n in st_launches.items():
        launches.setdefault(k, {})["stochastic"] = n
    del engine, model
    torch.cuda.empty_cache()
    return launches, stats


def phase_launcher_and_refusals(seed, card):
    """Phase 15. Returns ({kernel: {path: launches}}, stats)."""
    t0 = time.monotonic()
    root = Path("build") / "phase15"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    launches = {name: {} for name in launch_counters()}
    a_launches, a_stats = phase15_launcher(seed, root)
    for k, n in a_launches.items():
        launches[k]["launcher_rank0"] = n
    b_root = root / "dp2"
    b_root.mkdir()
    b_launches, b_stats = phase15_refusals_dp2(seed, b_root)
    c_launches, c_stats = phase15_one_process(seed)
    for part in (b_launches, c_launches):
        for k, by_path in part.items():
            launches[k].update(by_path)
    stats = {"card": card, "launcher": a_stats, "dp2": b_stats,
             "one_process": c_stats, "wall_s": time.monotonic() - t0}
    log(f"phase 15: {stats['wall_s']:.1f} s")
    return launches, stats


# ---------------------------------------------------------------------------
# phase 16: tensor parallelism (the model axis) on two ranks of the card
# ---------------------------------------------------------------------------
P16_MP = 2
P16_MICRO, P16_ACCUM, P16_WINDOWS = 2, 2, 2
P16_RTOL = 2e-4


def p16_batches(seed):
    """One window: P16_ACCUM micro-batches of P16_MICRO x 1024 token ids
    from ``seed`` (every model rank feeds the same rows)."""
    from deepspeed_tpu_torch import GPT2Config

    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, GPT2Config.small().vocab_size,
                        (P16_MICRO * P16_ACCUM, 1024), generator=g).cuda()
    return [(ids[i * P16_MICRO:(i + 1) * P16_MICRO],) * 2
            for i in range(P16_ACCUM)]


def p16_engine(seed, mp, optimizer, precision, dropout, lr):
    """initialize() on GPT-2 small at full width and depth, at a model
    axis of ``mp`` with the model's partition_specs (ZeRO stage 2, which
    at data size 1 is stage 0, as in the JAX engine)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    model = GPT2LMHeadModel(GPT2Config.small(dropout=dropout), device="cuda",
                            seed=seed)
    cfg = p14_config(optimizer, precision, 2, P16_MICRO, 1,
                     {"mesh": {"model_parallel_size": mp}})
    cfg["optimizer"]["params"]["lr"] = lr
    cfg.update(train_batch_size=P16_MICRO * P16_ACCUM,
               gradient_accumulation_steps=P16_ACCUM)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config_params=cfg,
        param_specs=(deepspeed_tpu_torch.partition_specs(model) if mp > 1
                     else None))
    return engine


def windows_with_hook(engine, batches, n, after_first=None):
    """``n`` windows of ``engine.train_batch(batches())``: their losses,
    and the seconds ``after_first(engine)`` took after the first."""
    losses, hook_s = [], 0.0
    for w in range(n):
        losses.append(float(engine.train_batch(batches())))
        if w == 0 and after_first is not None:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            after_first(engine)
            hook_s = time.monotonic() - t0
    return losses, hook_s


def p16_windows(engine, seed, after_first=None):
    """P16_WINDOWS windows on one batch: losses, launches, the seconds of
    a window, and the memory held after initialize() and the peak;
    ``after_first`` as in p18_windows."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    batches = p16_batches(seed)
    zero_launches()
    t0 = time.monotonic()
    losses, hook_s = windows_with_hook(engine, lambda: iter(batches),
                                       P16_WINDOWS, after_first)
    torch.cuda.synchronize()
    return {"losses": losses, "launches": read_launches(),
            "window_s": (time.monotonic() - t0 - hook_s) / P16_WINDOWS,
            "held_gb": held / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "skipped": engine.skipped_steps}


def p16_fingerprint(engine, seed):
    """The eval loss of a fixed batch (2 rows)."""
    ids = p16_batches(seed + 1)[0][0]
    engine.eval()
    with torch.no_grad():
        loss = float(engine(ids, ids).detach().float())
    engine.train()
    return loss


def p16_check_kernels(engine, seed):
    """This rank's kernels against their plain versions at its shapes: the
    flash forward, dQ and dK/dV on [P16_MICRO, 12 / mp heads, 1024, 64]
    (bf16, causal, dropout 0.1), and LAMB phase 1 over the rank's
    parameter shards (float32 grads). Returns the max errors."""
    from deepspeed_tpu_torch.ops import attention as A
    from deepspeed_tpu_torch.ops.fused_lamb import (
        lamb_phase1,
        lamb_phase1_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    heads = 12 // engine.mp_world_size
    shape = (P16_MICRO, heads, 1024, 64)
    q, k, v, dout = (torch.randn(shape, device="cuda", generator=gen
                                 ).to(torch.bfloat16) for _ in range(4))
    seed_k = 4321 + 15_485_863 * engine.model_rank
    args = (q, k, v, None, True, None, DROPOUT, seed_k)
    out, lse = A.flash_fwd(*args)
    ref, ref_lse = A.flash_fwd_plain(*args)
    errs = {"shape": list(shape), "flash_fwd": check_close(
        f"phase 16 rank {engine.model_rank} flash_fwd", out, ref,
        torch.bfloat16)}
    delta = (dout.float() * ref.float()).sum(dim=-1)
    bargs = (q, k, v, None, dout, ref_lse, delta, True, None, DROPOUT,
             seed_k)
    dq = A.flash_bwd_dq(*bargs)
    dk, dv = A.flash_bwd_dkv(*bargs)
    want = (A.flash_bwd_dq_plain(*bargs), *A.flash_bwd_dkv_plain(*bargs))
    for name, got, ref_g in zip(("flash_bwd_dq", "dk", "dv"), (dq, dk, dv),
                                want):
        key = "flash_bwd_dq" if name == "flash_bwd_dq" else "flash_bwd_dkv"
        err = check_close(f"phase 16 rank {engine.model_rank} {name}", got,
                          ref_g, torch.bfloat16, scaled=True)
        errs[key] = max(errs.get(key, 0.0), err)
    from deepspeed_tpu_torch.ops.optimizers import bias_corrections

    ps = [p.detach().float() for p in engine.module_params.values()]

    def noise(scale):
        return [torch.randn(p.shape, device="cuda", generator=gen) * scale
                for p in ps]

    gs = noise(1e-3)
    zeros = [torch.zeros_like(p) for p in ps]
    # (name, m, v, step): every run's first step (zero moments, step 1's
    # bias corrections); zero moments at step 3's corrections; and phase
    # 3b's operands (lamb_operands: nonzero moments, step 3)
    cases = [("first_step", zeros, zeros, 1), ("zero_moments_step3", zeros,
                                                zeros, 3),
             ("step3", noise(1e-4), [x * x for x in noise(1e-3)], 3)]
    errs["lamb_cases"] = {}
    worst_all = 0.0
    for case, m0, v0, step in cases:
        c1, c2 = bias_corrections(0.9, 0.999, step)
        runs = []
        for fn in (lamb_phase1, lamb_phase1_plain):
            ms, vs = [m.clone() for m in m0], [v.clone() for v in v0]
            us = [torch.empty_like(p) for p in ps]
            wsq, usq = fn(ps, gs, ms, vs, us, c1, c2, 0.5, b1=0.9,
                          b2=0.999, eps=1e-8, weight_decay=0.01,
                          eps_inside_sqrt=False)
            torch.cuda.synchronize()
            runs.append((wsq, usq, ms, vs, us))
        stats = {}
        for i, what in ((2, "m"), (3, "v"), (4, "u")):
            pairs = list(zip(runs[0][i], runs[1][i]))
            rel = max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                      for a, b in pairs)
            unequal = sum(int((a != b).sum()) for a, b in pairs)
            ulps = max(int((a.view(torch.int32).long()
                            - b.view(torch.int32).long()).abs().max())
                       for a, b in pairs)
            stats[what] = {"max_rel_err": rel, "unequal": unequal,
                           "max_ulps": ulps}
        partial = max(float(((runs[0][i] - runs[1][i]).abs()
                             / runs[1][i].abs().clamp_min(1e-30)).max())
                      for i in (0, 1))
        stats["partials_rel_err"] = partial
        errs["lamb_cases"][case] = stats
        log(f"  phase 16 rank {engine.model_rank} lamb_phase1 {case}: "
            + "; ".join(f"{w} rel {stats[w]['max_rel_err']:.3e}, "
                        f"{stats[w]['unequal']} unequal, max "
                        f"{stats[w]['max_ulps']} ulps" for w in "mvu")
            + f"; partials rel {partial:.3e}")
        for what in ("m", "v", "u"):
            if stats[what]["max_rel_err"] > LAMB_RTOL:
                fail(f"phase 16 {case}: lamb_phase1 {what} rel err "
                     f"{stats[what]['max_rel_err']:.3e} > {LAMB_RTOL}")
        if partial > LAMB_RTOL:
            fail(f"phase 16 {case}: lamb_phase1 block partials rel err "
                 f"{partial:.3e}")
        worst_all = max(worst_all, partial,
                        *(stats[w]["max_rel_err"] for w in "mvu"))
    # m, v and u are bitwise the plain version's on phase 3b's operands
    # (the kernel repeats PyTorch's roundings: csrc/lamb_phase1.cu)
    if any(errs["lamb_cases"]["step3"][w]["unequal"] for w in "mvu"):
        fail("phase 16: lamb_phase1 m, v or u on the rank's shards is not "
             "bitwise the plain version's on phase 3b's operands")
    errs["lamb_phase1"] = worst_all
    errs["lamb_tensors"] = len(ps)
    return errs


def p16_partition(engine, seed):
    """GPT-2 small's blocks each through the activation API's
    checkpoint (checkpointing.checkpoint), partition_activations off and
    on: the loss and every gradient, and the peak memory above what the
    step starts with."""
    from deepspeed_tpu_torch import checkpointing as act
    from deepspeed_tpu_torch.ops.cross_entropy import (
        vocab_parallel_lm_head_loss,
    )
    from deepspeed_tpu_torch.ops.transformer import (
        layer_norm_apply,
        transformer_block_apply,
    )
    from deepspeed_tpu_torch.parallel.tensor import vocab_parallel_lookup

    model = engine.module
    tp = model.tensor_parallel
    cfg = model.layer_config
    ids = p16_batches(seed + 2)[0][0]
    out = {}
    for on in (False, True):
        act.configure(engine.mpu, partition_activations=on)
        for p in model.parameters():
            p.grad = None
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        x = (vocab_parallel_lookup(ids, model.wte, tp)
             + model.wpe[None, :ids.shape[1]])
        for layer in model.h:
            x = act.checkpoint(
                lambda h, layer=layer: transformer_block_apply(
                    cfg, layer, h, None, causal=True), x)
        x = layer_norm_apply(cfg, x, model.ln_f.weight, model.ln_f.bias)
        loss = vocab_parallel_lm_head_loss(
            x[:, :-1], model.wte, ids[:, 1:], tp,
            block_rows=model.config.ce_block_rows)
        loss.backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        out[on] = (loss.item(), [p.grad.detach().clone()
                                 for p in model.parameters()], peak)
        del x, loss
    act.configure(None, partition_activations=False)
    (loss_off, g_off, peak_off), (loss_on, g_on, peak_on) = out[False], out[
        True]
    err = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(g_on, g_off))
    for p in model.parameters():
        p.grad = None
    return {"loss_off": loss_off, "loss_on": loss_on,
            "grad_max_rel_err": err, "peak_off_gb": peak_off / 1e9,
            "peak_on_gb": peak_on / 1e9}


def phase16_rank(spec_path):
    """One of phase 16's two ranks (a subprocess): a model line of the
    gloo group the phase made. bf16 FusedLamb with dropout; the kernels at
    this rank's shapes; float32 Adam at dropout 0 (its whole parameters
    and a checkpoint saved for the phase); partition_activations off and
    on. Writes its results as JSON."""
    import torch.distributed as dist

    spec = json.loads(Path(spec_path).read_text())
    rank, seed = spec["rank"], spec["seed"]
    root = Path(spec["out"]).parent
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{spec['port']}", rank=rank,
        world_size=P16_MP)
    out = {}
    engine = p16_engine(seed, P16_MP, "FusedLamb", "bf16", DROPOUT, 1e-3)
    out["bf16"] = p16_windows(engine, seed)
    out["local_shapes"] = {n: list(p.shape)
                           for n, p in engine.module.named_parameters()
                           if n.startswith(("wte", "h.0."))}
    out["kernels"] = p16_check_kernels(engine, seed + 11 + rank)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    engine = p16_engine(seed, P16_MP, "Adam", "fp32", 0.0, 1e-4)
    out["fp32"] = p16_windows(engine, seed)
    full = engine.full_parameters()
    if rank == 0:
        torch.save({n: t.detach().cpu() for n, t in full.items()},
                   root / "params_mp2.pt")
    del full
    engine.save_checkpoint(str(root / "ckpt"), tag="mp2")
    out["fp32"]["fingerprint"] = p16_fingerprint(engine, seed)
    out["partition"] = p16_partition(engine, seed)
    del engine
    Path(spec["out"]).write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def phase_model_parallel(seed, card):
    """Phase 16. Returns ({kernel: {path: launches}}, stats)."""
    t0 = time.monotonic()
    root = Path("build") / "phase16"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ranks = p14_spawn(seed, root, timeout_s=600, flag="--phase16-rank",
                      phase="16", world=P16_MP)
    launches = {name: {} for name in launch_counters()}
    micro_steps = P16_WINDOWS * P16_ACCUM
    for rank, r in enumerate(ranks):
        for run in ("bf16", "fp32"):
            got = r[run]
            if not all(math.isfinite(v) for v in got["losses"]) or got[
                    "skipped"]:
                fail(f"phase 16 rank {rank} {run}: losses {got['losses']}")
            for k in TRAIN_KERNELS:
                if got["launches"][k] != N_LAYER * micro_steps:
                    fail(f"phase 16 rank {rank} {run}: {k} launched "
                         f"{got['launches'][k]} times, want "
                         f"{N_LAYER * micro_steps} (12 a micro-step at "
                         f"{12 // P16_MP} heads)")
            for k, n in got["launches"].items():
                path = f"mp2_rank{rank}"
                launches[k][path] = launches[k].get(path, 0) + n
        if r["bf16"]["launches"]["lamb_phase1"] != 6 * P16_WINDOWS:
            fail(f"phase 16 rank {rank}: lamb_phase1 launched "
                 f"{r['bf16']['launches']['lamb_phase1']} times, want 6 a "
                 "step")
        part = r["partition"]
        if part["loss_on"] != part["loss_off"] or part[
                "grad_max_rel_err"] > 1e-6:
            fail(f"phase 16 rank {rank}: partition_activations changed the "
                 f"numbers: {part}")
        if not part["peak_on_gb"] < part["peak_off_gb"]:
            fail(f"phase 16 rank {rank}: partition_activations peak "
                 f"{part['peak_on_gb']} GB is not below "
                 f"{part['peak_off_gb']} GB")
    for run in ("bf16", "fp32"):
        if ranks[0][run]["losses"] != ranks[1][run]["losses"]:
            fail(f"phase 16 {run}: the model ranks return different losses")
    for rank, r in enumerate(ranks):
        log(f"  rank {rank} launches a micro-step: "
            + ", ".join(f"{k} {r['bf16']['launches'][k] / micro_steps:g}"
                        for k in TRAIN_KERNELS)
            + f" (at {12 // P16_MP} heads); lamb_phase1 a step "
            f"{r['bf16']['launches']['lamb_phase1'] / P16_WINDOWS:g}")
        for case, st in r["kernels"]["lamb_cases"].items():
            log(f"  rank {rank} lamb_phase1 vs plain, {case}: "
                + "; ".join(f"{w} max rel {st[w]['max_rel_err']:.3e}, "
                            f"{st[w]['unequal']} unequal, max "
                            f"{st[w]['max_ulps']} ulps" for w in "mvu")
                + f"; partials max rel {st['partials_rel_err']:.3e}")
    log(f"  mp 2 bf16 FusedLamb (dropout 0.1): losses "
        f"{ranks[0]['bf16']['losses']}; held GB "
        f"{[r['bf16']['held_gb'] for r in ranks]}, peak GB "
        f"{[r['bf16']['peak_gb'] for r in ranks]}; s/window "
        f"{[r['bf16']['window_s'] for r in ranks]} (two ranks sharing one "
        "card over gloo: not an mp 2 speed)")
    # the mp 1 run of the same float32 steps, in this process
    engine = p16_engine(seed, 1, "Adam", "fp32", 0.0, 1e-4)
    ref = p16_windows(engine, seed)
    p14_close("phase 16 float32 mp 2 vs mp 1 losses",
              ranks[0]["fp32"]["losses"], ref["losses"])
    mp2 = torch.load(root / "params_mp2.pt", weights_only=True)
    worst = 0.0
    for n, p in engine.module.named_parameters():
        want = p.detach().float().cpu()
        got = mp2[n]
        if tuple(got.shape) != tuple(want.shape) or not torch.allclose(
                got, want, rtol=P16_RTOL, atol=1e-5):
            fail(f"phase 16: float32 mp 2 parameter {n} differs from mp 1's")
        worst = max(worst, float((got - want).abs().max()))
    del engine, mp2
    torch.cuda.empty_cache()
    # the mp 2 checkpoint at mp 1
    engine = p16_engine(seed + 7, 1, "Adam", "fp32", 0.0, 1e-4)
    path, _ = engine.load_checkpoint(str(root / "ckpt"))
    fp1 = p16_fingerprint(engine, seed)
    fp2 = ranks[0]["fp32"]["fingerprint"]
    if path is None or not math.isclose(fp1, fp2, rel_tol=1e-5):
        fail(f"phase 16: the mp 2 checkpoint at mp 1: fingerprint {fp1} != "
             f"{fp2}")
    del engine
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    stats = {"card": card, "micro_rows": P16_MICRO,
             "accum": P16_ACCUM, "windows": P16_WINDOWS,
             "bf16": [r["bf16"] for r in ranks],
             "fp32_losses": ranks[0]["fp32"]["losses"],
             "fp32_mp1_losses": ref["losses"],
             "fp32_max_abs_param_diff": worst,
             "fp32_held_gb": [r["fp32"]["held_gb"] for r in ranks],
             "fp32_peak_gb": [r["fp32"]["peak_gb"] for r in ranks],
             "mp1_held_gb": ref["held_gb"], "mp1_peak_gb": ref["peak_gb"],
             "fingerprint_mp2": fp2, "fingerprint_mp1": fp1,
             "partition": [r["partition"] for r in ranks],
             "sharded_kernels": [r["kernels"] for r in ranks],
             "local_shapes": ranks[1]["local_shapes"],
             "wall_s": time.monotonic() - t0}
    log(f"phase 16: float32 mp 2 = mp 1 (max |param diff| {worst:.3e}); "
        f"fingerprint mp 2 {fp2} at mp 1 {fp1}; partition peaks "
        f"{[(r['partition']['peak_off_gb'], r['partition']['peak_on_gb']) for r in ranks]} "
        f"GB; {stats['wall_s']:.1f} s")
    return launches, stats


# ---------------------------------------------------------------------------
# phase 17: serving over the model axis and sequence parallelism in
# training, each on two ranks of the card
# ---------------------------------------------------------------------------
P17_WORLD = 2
P17_PROMPTS = (40, 77, 130, 200)
P17_ADAPTERS = ("a", "b", "c", None)  # three adapters and the base
P17_NEW = 24
P17_UL_SHAPE = (P16_MICRO, 12 // P17_WORLD, 1024, 64)  # Ulysses' heads
P17_SERVE_SLOTS, P17_PAGE = 4, 16


def p17_serve_config(dtype):
    return {"inference": {
        "max_batch_slots": P17_SERVE_SLOTS, "kv_block_size": P17_PAGE,
        "fused_decode": True, "dtype": dtype, "sampling": {"greedy": True}},
        "adapters": {"enabled": True, "rank": LORA_RANK,
                     "pool_slots": LORA_POOL_SLOTS}}


def p17_serving_inputs(seed):
    """GPT-2 small from ``seed`` (its state), three synthetic adapters and
    the four prompts."""
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    model = GPT2LMHeadModel(GPT2Config.small(dropout=0.0), device="cuda",
                            seed=seed)
    base = {n: t.detach().cpu() for n, t in model.state_dict().items()}
    adapters = {n: synthetic_adapter(base, seed + 17 + i)
                for i, n in enumerate(P17_ADAPTERS) if n is not None}
    return model, adapters, p17_prompts(seed, model.config.vocab_size)


def p17_prompts(seed, vocab):
    g = torch.Generator().manual_seed(seed + 171)
    return [random_tokens(g, n, vocab) for n in P17_PROMPTS]


def p17_serve(seed, dtype, world):
    """One serving run: every rank builds the engine (at a model axis of
    ``world``, or one process), the leader loads the adapters and serves
    the prompts in one batch, a follower follows. Returns the leader's
    tokens, the launches and the bytes the engine holds on this rank."""
    import deepspeed_tpu_torch

    model, adapters, prompts = p17_serving_inputs(seed)
    config = p17_serve_config(dtype)
    if world > 1:
        config["mesh"] = {"model_parallel_size": world}
    engine = deepspeed_tpu_torch.init_inference(model=model, config=config)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    pool = engine._adapter_pool

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    out = {"weights_gb": nbytes(engine.model.parameters()) / 1e9,
           "kv_pool_gb": nbytes((engine._cache.k, engine._cache.v)) / 1e9,
           "adapter_pool_gb": nbytes(
               [t for ab in pool.values() for t in ab]) / 1e9,
           "kv_pool_shape": list(engine._cache.k.shape),
           "held_gb": torch.cuda.memory_allocated() / 1e9}
    zero_launches()
    if engine.is_leader:
        for name, state in adapters.items():
            engine.load_adapter(name, adapter_state=state)
        tokens, st = run_batch(engine, prompts, list(P17_ADAPTERS), P17_NEW)
        out.update(tokens=tokens, stats=st)
        engine.close()
    else:
        engine.serve_forever()
    torch.cuda.synchronize()
    out["launches"] = read_launches()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def p17_train_engine(seed, impl, optimizer, precision, dropout, lr, sp):
    """initialize() on GPT-2 small at full width and depth at a sequence
    axis of ``sp`` (``impl``: "ulysses" or "ring"), 2 rows x 1024 a
    micro-step, 2 micro-steps a window (phase 16's batches)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    model = GPT2LMHeadModel(GPT2Config.small(dropout=dropout), device="cuda",
                            seed=seed)
    model.layer_config.seq_parallel_impl = impl
    cfg = p14_config(optimizer, precision, 0, P16_MICRO, 1,
                     {"mesh": {"sequence_parallel_size": sp}})
    cfg["optimizer"]["params"]["lr"] = lr
    cfg.update(train_batch_size=P16_MICRO * P16_ACCUM,
               gradient_accumulation_steps=P16_ACCUM)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model,
                                                config_params=cfg)
    return engine


def p17_record_shapes():
    """Record the q shape of every attention kernel launch (through the
    wrappers' shared argument check); returns the set it fills."""
    from deepspeed_tpu_torch.ops import attention as A

    shapes = set()
    check = A._check_cuda

    def recording(name, kernel, q, *rest):
        shapes.add((name, tuple(q.shape)))
        return check(name, kernel, q, *rest)

    A._check_cuda = recording
    return shapes


def phase17_rank(spec_path):
    """One of phase 17's two ranks (a subprocess) of the gloo group the
    phase makes: (a) serving at a model axis of 2, float32 and bf16; (b)
    training at a sequence axis of 2: bf16 FusedLamb with dropout through
    Ulysses (the kernels' shapes recorded) and the ring, then float32
    Adam at dropout 0 through both. Writes its results as JSON."""
    import torch.distributed as dist

    spec = json.loads(Path(spec_path).read_text())
    rank, seed = spec["rank"], spec["seed"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{spec['port']}", rank=rank,
        world_size=P17_WORLD)
    out = {"serve": {dt: p17_serve(seed, dt, P17_WORLD)
                     for dt in ("fp32", "bf16")}}
    shapes = p17_record_shapes()
    out["train"] = {}
    for name, impl, optimizer, precision, dropout, lr in (
            ("bf16_ulysses", "ulysses", "FusedLamb", "bf16", DROPOUT, 1e-3),
            ("bf16_ring", "ring", "FusedLamb", "bf16", DROPOUT, 1e-3),
            ("fp32_ulysses", "ulysses", "Adam", "fp32", 0.0, 1e-4),
            ("fp32_ring", "ring", "Adam", "fp32", 0.0, 1e-4)):
        shapes.clear()
        engine = p17_train_engine(seed, impl, optimizer, precision, dropout,
                                  lr, P17_WORLD)
        got = p16_windows(engine, seed)
        got["kernel_shapes"] = sorted([n, list(s)] for n, s in shapes)
        got["coords"] = [engine.data_rank, engine.seq_rank]
        out["train"][name] = got
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    Path(spec["out"]).write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def p17_check_kernels(seed):
    """Each kernel of phase 17's paths against its plain version at the
    shapes a rank gives it: the flash forward, dQ and dK/dV at Ulysses'
    [2, 6, 1024, 64] (bf16, causal, dropout 0.1), paged decode at the
    serving pool's 6 heads a rank, and SGMV on each target's factor
    shards (the qkv and inter_w B's 1152 and 1536 output columns, the
    attn_ow and output_w A's 384 and 1536 input rows), float32 and bf16.
    Returns the max errors."""
    from deepspeed_tpu_torch.ops import attention as A
    from deepspeed_tpu_torch.ops.decode_attention import (
        lora_sgmv,
        lora_sgmv_plain,
        paged_flash_decode,
        paged_flash_decode_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    q, k, v, dout = (torch.randn(P17_UL_SHAPE, device="cuda", generator=gen
                                 ).to(torch.bfloat16) for _ in range(4))
    args = (q, k, v, None, True, None, DROPOUT, 4321)
    out, lse = A.flash_fwd(*args)
    ref, ref_lse = A.flash_fwd_plain(*args)
    errs = {"flash_fwd": check_close("phase 17 flash_fwd [2, 6, 1024, 64]",
                                     out, ref, torch.bfloat16)}
    delta = (dout.float() * ref.float()).sum(dim=-1)
    bargs = (q, k, v, None, dout, ref_lse, delta, True, None, DROPOUT, 4321)
    got = (A.flash_bwd_dq(*bargs), *A.flash_bwd_dkv(*bargs))
    want = (A.flash_bwd_dq_plain(*bargs), *A.flash_bwd_dkv_plain(*bargs))
    for name, a, b in zip(("flash_bwd_dq", "dk", "dv"), got, want):
        key = "flash_bwd_dq" if name == "flash_bwd_dq" else "flash_bwd_dkv"
        err = check_close(f"phase 17 {name} [2, 6, 1024, 64]", a, b,
                          torch.bfloat16, scaled=True)
        errs[key] = max(errs.get(key, 0.0), err)
    heads = 12 // P17_WORLD
    mb = 1024 // P17_PAGE
    pages = P17_SERVE_SLOTS * mb + 1
    for dtype in (torch.float32, torch.bfloat16):
        qd = torch.randn(P17_SERVE_SLOTS, heads, 64, device="cuda",
                         generator=gen).to(dtype)
        kp, vp = (torch.randn(pages, P17_PAGE, heads, 64, device="cuda",
                              generator=gen).to(dtype) for _ in range(2))
        tables = (torch.randperm(pages - 1, device="cuda", generator=gen)
                  + 1).reshape(P17_SERVE_SLOTS, mb).to(torch.int32)
        positions = torch.tensor([39, 300, 1023, 0], dtype=torch.int32,
                                 device="cuda")
        tag = f"phase 17 paged_decode {str(dtype)[6:]} [{P17_SERVE_SLOTS}, {heads}, 64]"
        errs[f"paged_decode {str(dtype)[6:]}"] = check_close(
            tag, paged_flash_decode(qd, kp, vp, tables, positions),
            paged_flash_decode_plain(qd, kp, vp, tables, positions), dtype)
        for target, (din, dout_) in {
                "attn_qkvw": (768, 2304 // P17_WORLD),
                "inter_w": (768, 3072 // P17_WORLD),
                "attn_ow": (768 // P17_WORLD, 768),
                "output_w": (3072 // P17_WORLD, 768)}.items():
            x, a_pool, b_pool, ids = sgmv_case("cuda", gen, dtype, din,
                                               dout_, P17_SERVE_SLOTS)
            tag = f"phase 17 sgmv {target} {str(dtype)[6:]} in {din} out {dout_}"
            key = f"sgmv {str(dtype)[6:]}"
            errs[key] = max(errs.get(key, 0.0), check_close(
                tag, lora_sgmv(x, a_pool, b_pool, ids),
                lora_sgmv_plain(x, a_pool, b_pool, ids), dtype,
                scaled=dtype != torch.float32))
    return errs


def phase_serve_and_sequence(seed, card):
    """Phase 17. Returns ({kernel: {path: launches}}, stats)."""
    t0 = time.monotonic()
    root = Path("build") / "phase17"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ranks = p14_spawn(seed, root, timeout_s=600, flag="--phase17-rank",
                      phase="17", world=P17_WORLD)
    launches = {name: {} for name in launch_counters()}
    # (a) serving at mp 2: rows 1, 6 and 7 on each rank
    for rank, r in enumerate(ranks):
        for dt, got in r["serve"].items():
            for k in ("flash_fwd", "paged_decode", "sgmv"):
                if got["launches"][k] <= 0:
                    fail(f"phase 17 serving {dt} rank {rank}: {k} launched "
                         f"no time ({got['launches']})")
            if got["kv_pool_shape"][3] != 12 // P17_WORLD:
                fail(f"phase 17 serving rank {rank}: pool {got['kv_pool_shape']}"
                     " does not hold 6 heads")
            for k, n in got["launches"].items():
                path = f"serve_mp2_{dt}_rank{rank}"
                launches[k][path] = n
            log(f"  serving {dt} rank {rank}: launches "
                + ", ".join(f"{k} {got['launches'][k]}" for k in
                            ("flash_fwd", "paged_decode", "sgmv"))
                + f"; holds weights {got['weights_gb']:.4f} GB, KV pool "
                f"{got['kv_pool_gb']:.4f} GB {got['kv_pool_shape']}, adapter "
                f"pool {got['adapter_pool_gb']:.4f} GB (allocated "
                f"{got['held_gb']:.4f} GB)")
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    vocab = GPT2Config.small().vocab_size
    prompts = p17_prompts(seed, vocab)

    serve_ref = {dt: p17_serve(seed, dt, 1) for dt in ("fp32", "bf16")}
    ref_model = GPT2LMHeadModel(GPT2Config.small(dropout=0.0), device="cuda",
                                seed=seed)
    ref_model.eval()
    # the flips are read on the base model's forward (the adapters'
    # requests included: a gap of the base is what the check can read)
    same_tokens("phase 17 float32 serving mp 2 vs mp 1", prompts,
                ranks[0]["serve"]["fp32"]["tokens"],
                serve_ref["fp32"]["tokens"], ref_model, vocab)
    flip = bf16_divergence("phase 17 bf16 serving mp 2 vs mp 1", prompts,
                           ranks[0]["serve"]["bf16"]["tokens"],
                           serve_ref["bf16"]["tokens"], ref_model, vocab)
    del ref_model
    torch.cuda.empty_cache()
    # (b) training at sp 2
    micro_steps = P16_WINDOWS * P16_ACCUM
    for rank, r in enumerate(ranks):
        for run, got in r["train"].items():
            if not all(math.isfinite(v) for v in got["losses"]) or got[
                    "skipped"]:
                fail(f"phase 17 rank {rank} {run}: losses {got['losses']}")
            want = N_LAYER * micro_steps if "ulysses" in run else 0
            for k in TRAIN_KERNELS:
                if got["launches"][k] != want:
                    fail(f"phase 17 rank {rank} {run}: {k} launched "
                         f"{got['launches'][k]} times, want {want}")
            if "ulysses" in run:
                shapes = {tuple(s) for _, s in got["kernel_shapes"]}
                if shapes != {P17_UL_SHAPE}:
                    fail(f"phase 17 rank {rank} {run}: attention kernels "
                         f"at {sorted(shapes)}, want {P17_UL_SHAPE}")
            if run.startswith("bf16") and got["launches"][
                    "lamb_phase1"] != 6 * P16_WINDOWS:
                fail(f"phase 17 rank {rank} {run}: lamb_phase1 launched "
                     f"{got['launches']['lamb_phase1']} times")
            for k, n in got["launches"].items():
                launches[k][f"sp2_{run}_rank{rank}"] = n
            log(f"  training {run} rank {rank} (sequence rank "
                f"{got['coords'][1]}): losses {got['losses']}; held "
                f"{got['held_gb']:.4f} GB, peak {got['peak_gb']:.4f} GB; "
                f"{got['window_s']:.3f} s a window (two ranks on one card "
                "over gloo: not an sp 2 speed); launches "
                + ", ".join(f"{k} {got['launches'][k]}" for k in
                            (*TRAIN_KERNELS, "lamb_phase1")))
    for run in ranks[0]["train"]:
        if ranks[0]["train"][run]["losses"] != ranks[1]["train"][run][
                "losses"]:
            fail(f"phase 17 {run}: the sequence ranks return different "
                 "losses")
    engine = p16_engine(seed, 1, "Adam", "fp32", 0.0, 1e-4)
    ref = p16_windows(engine, seed)
    del engine
    torch.cuda.empty_cache()
    for run in ("fp32_ulysses", "fp32_ring"):
        p14_close(f"phase 17 float32 sp 2 ({run}) vs sp 1 losses",
                  ranks[0]["train"][run]["losses"], ref["losses"])
    kernel_errs = p17_check_kernels(seed)
    stats = {"card": card, "serving": {
        "prompts": list(P17_PROMPTS), "adapters": list(P17_ADAPTERS),
        "new_tokens": P17_NEW, "ranks": [
            {dt: {k: v for k, v in got.items() if k != "tokens"}
             for dt, got in r["serve"].items()} for r in ranks],
        "mp1": {dt: {k: v for k, v in got.items() if k != "tokens"}
                for dt, got in serve_ref.items()},
        "bf16_flip": flip},
        "training": {"ranks": [r["train"] for r in ranks],
                     "fp32_sp1_losses": ref["losses"],
                     "sp1_held_gb": ref["held_gb"],
                     "sp1_peak_gb": ref["peak_gb"]},
        "sharded_kernels": kernel_errs,
        "wall_s": time.monotonic() - t0}
    log(f"phase 17: float32 serving mp 2 = mp 1; bf16 flip {flip}; float32 "
        f"sp 2 = sp 1 (ulysses {ranks[0]['train']['fp32_ulysses']['losses']},"
        f" ring {ranks[0]['train']['fp32_ring']['losses']}, sp 1 "
        f"{ref['losses']}); {stats['wall_s']:.1f} s")
    return launches, stats


# ---------------------------------------------------------------------------
# phase 18: MoE with experts over the data axis (A7c), the pipe axis (A7d)
# ---------------------------------------------------------------------------
P18_WORLD = 2
P18_EXPERTS, P18_TOP_K, P18_CAPACITY = 8, 2, 1.25
P18_ROWS = 8  # a micro-step's global rows (ep 2: 4 a rank)
P18_WINDOWS = 2  # one micro-step a window, one fixed batch
P18_MICROBATCHES = 4  # pp 2: 4 microbatches of 2 rows
P18_RTOL = 2e-4
# the runs of phase 18's two ranks: (name, model kind, optimizer,
# precision, dropout, lr, mesh block)
P18_RANK_RUNS = (
    ("ep2_fp32", "moe", "Adam", "fp32", 0.0, 1e-4,
     {"data_parallel_size": P18_WORLD}),
    ("pp2_fp32", "pp", "Adam", "fp32", 0.0, 1e-4,
     {"pipeline_parallel_size": P18_WORLD}),
    ("pp2_bf16", "pp", "FusedLamb", "bf16", DROPOUT, 1e-3,
     {"pipeline_parallel_size": P18_WORLD}),
)
# the attention kernels' q shape a micro-step: one rank's 8 rows, an
# expert rank's 4, a pipeline microbatch's 2
P18_SHAPES = {"moe": (P18_ROWS, 12, 1024, 64),
              "ep2": (P18_ROWS // P18_WORLD, 12, 1024, 64),
              "pp2": (P18_ROWS // P18_MICROBATCHES, 12, 1024, 64)}


def p18_batch(seed):
    """One micro-step's global batch: P18_ROWS x 1024 token ids."""
    from deepspeed_tpu_torch import GPT2Config

    g = torch.Generator().manual_seed(seed + 18)
    return torch.randint(0, GPT2Config.small().vocab_size, (P18_ROWS, 1024),
                         generator=g).cuda()


def p18_engine(seed, kind, optimizer, precision, dropout, lr, mesh=None,
               extra=None):
    """initialize() on GPT-2 small at full width and depth: ``kind`` "moe"
    (8 experts, top-2, capacity 1.25: 320 slots a row and expert), "pp"
    (2 stages of 6 blocks, 4 microbatches) or "dense"; ZeRO stage 1
    (stage 0 at one data rank), one micro-step a window; ``extra`` more
    engine config (phase 22: int8 moments)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    fields = {}
    if kind == "moe":
        fields = dict(moe_experts=P18_EXPERTS, moe_top_k=P18_TOP_K,
                      moe_capacity_factor=P18_CAPACITY)
    elif kind == "pp":
        fields = dict(pipeline_stages=P18_WORLD,
                      pipeline_microbatches=P18_MICROBATCHES)
    gc.collect()
    torch.cuda.empty_cache()
    model = GPT2LMHeadModel(GPT2Config.small(dropout=dropout, **fields),
                            device="cuda", seed=seed)
    dp = (mesh or {}).get("data_parallel_size", 1)
    cfg = p14_config(optimizer, precision, 1, P18_ROWS // dp, dp,
                     dict(extra or {}, **({"mesh": mesh} if mesh else {})))
    cfg["optimizer"]["params"]["lr"] = lr
    engine, *_ = deepspeed_tpu_torch.initialize(model=model,
                                                config_params=cfg)
    return engine


def p18_windows(engine, seed, after_first=None):
    """P18_WINDOWS windows on this rank's rows of one batch: losses,
    launches, ``last_aux``, seconds a window, the parameters and bytes
    the module holds, the memory held after initialize() and the peak;
    ``after_first(engine)`` after the first window (phase 22: the int8
    state), out of the seconds."""
    rows = p18_batch(seed)
    dp = engine.dp_world_size
    k = P18_ROWS // dp
    rows = rows[engine.data_rank * k:(engine.data_rank + 1) * k]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.monotonic()
    losses, hook_s = windows_with_hook(
        engine, lambda: iter([(rows, rows)]), P18_WINDOWS, after_first)
    torch.cuda.synchronize()
    params = list(engine.module.parameters())
    return {"losses": losses, "launches": read_launches(),
            "window_s": (time.monotonic() - t0 - hook_s) / P18_WINDOWS,
            "aux": [[float(x) for x in a.reshape(-1)]
                    for a in engine.last_aux],
            "params_m": sum(p.numel() for p in params) / 1e6,
            "weights_gb": sum(p.numel() * p.element_size()
                              for p in params) / 1e9,
            "held_gb": held / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "skipped": engine.skipped_steps,
            "coords": [engine.pipe_rank, engine.data_rank]}


def p18_run(seed, name, kind, optimizer, precision, dropout, lr, mesh,
            shapes, extra=None, after_first=None, read=None):
    """One run: the engine, its windows (``after_first`` as in
    p18_windows), the attention kernels' shapes (and ``read(engine)``'s
    entries after the windows, phase 22's bytes)."""
    shapes.clear()
    engine = p18_engine(seed, kind, optimizer, precision, dropout, lr, mesh,
                        extra)
    got = p18_windows(engine, seed, after_first)
    got["kernel_shapes"] = sorted([n, list(s)] for n, s in shapes)
    if read is not None:
        got["held"] = read(engine)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return got


def phase18_rank(spec_path):
    """One of phase 18's two ranks (a subprocess) of the gloo group the
    phase makes: (b) float32 Adam on the MoE model with its experts over a
    data axis of 2 (4 a rank); (c) the pipe axis of 2 (6 blocks a stage):
    float32 Adam at dropout 0, then bf16 FusedLamb with dropout. Writes
    its results as JSON."""
    import torch.distributed as dist

    spec = json.loads(Path(spec_path).read_text())
    rank, seed = spec["rank"], spec["seed"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{spec['port']}", rank=rank,
        world_size=P18_WORLD)
    shapes = p17_record_shapes()
    out = {run[0]: p18_run(seed, *run, shapes) for run in P18_RANK_RUNS}
    Path(spec["out"]).write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def p18_check_run(tag, got, layers, micro_steps, lamb_steps, shape,
                  phase="18"):
    """A run's losses finite and no step skipped, each attention kernel
    launched ``layers`` times a micro-step at ``shape``, LAMB 6 times a
    step (5 large groups and one packed launch)."""
    if not all(math.isfinite(v) for v in got["losses"]) or got["skipped"]:
        fail(f"phase {phase} {tag}: losses {got['losses']}, skipped "
             f"{got['skipped']}")
    for k in TRAIN_KERNELS:
        if got["launches"][k] != layers * micro_steps:
            fail(f"phase {phase} {tag}: {k} launched {got['launches'][k]} "
                 f"times, want {layers * micro_steps}")
    if got["launches"]["lamb_phase1"] != 6 * lamb_steps:
        fail(f"phase {phase} {tag}: lamb_phase1 launched "
             f"{got['launches']['lamb_phase1']} times, want "
             f"{6 * lamb_steps}")
    shapes = {tuple(s) for _, s in got["kernel_shapes"]}
    if shapes != {shape}:
        fail(f"phase {phase} {tag}: attention kernels at {sorted(shapes)}, "
             f"want {shape}")
    log(f"  {tag}: losses {got['losses']}; {got['params_m']:.4f} M "
        f"parameters, {got['weights_gb']:.4f} GB of weights; held "
        f"{got['held_gb']:.4f} GB, peak {got['peak_gb']:.4f} GB; "
        f"{got['window_s']:.3f} s a window; launches "
        + ", ".join(f"{k} {got['launches'][k]}" for k in
                    (*TRAIN_KERNELS, "lamb_phase1")))


def p18_check_kernels(seed):
    """Each kernel of phase 18's paths against its plain version at the
    shapes the paths give it: the flash forward, dQ and dK/dV at an
    expert rank's [4, 12, 1024, 64] and a pipeline microbatch's [2, 12,
    1024, 64] (bf16, causal, dropout 0.1; float32 at the microbatch's),
    and LAMB phase 1 over an expert rank's ``h.*.moe.expert_in_w`` group
    (12 x [4, 768, 3072]) with bf16 grads: m, v and u bitwise, the block
    partials within LAMB_RTOL. Returns the max errors."""
    from deepspeed_tpu_torch.ops import attention as A
    from deepspeed_tpu_torch.ops.fused_lamb import (
        lamb_phase1,
        lamb_phase1_plain,
    )
    from deepspeed_tpu_torch.ops.optimizers import bias_corrections

    gen = torch.Generator(device="cuda").manual_seed(seed + 18)
    errs = {}
    for tag, shape, dtype in (("ep2", P18_SHAPES["ep2"], torch.bfloat16),
                              ("pp2", P18_SHAPES["pp2"], torch.bfloat16),
                              ("pp2", P18_SHAPES["pp2"], torch.float32)):
        q, k, v, dout = (torch.randn(shape, device="cuda", generator=gen
                                     ).to(dtype) for _ in range(4))
        args = (q, k, v, None, True, None, DROPOUT, 1818)
        out, _ = A.flash_fwd(*args)
        ref, ref_lse = A.flash_fwd_plain(*args)
        name = f"phase 18 {tag} {str(dtype)[6:]} {list(shape)}"
        errs["flash_fwd"] = max(errs.get("flash_fwd", 0.0), check_close(
            f"{name} flash_fwd", out, ref, dtype))
        delta = (dout.float() * ref.float()).sum(dim=-1)
        bargs = (q, k, v, None, dout, ref_lse, delta, True, None, DROPOUT,
                 1818)
        got = (A.flash_bwd_dq(*bargs), *A.flash_bwd_dkv(*bargs))
        want = (A.flash_bwd_dq_plain(*bargs), *A.flash_bwd_dkv_plain(*bargs))
        for what, a, b in zip(("flash_bwd_dq", "dk", "dv"), got, want):
            key = "flash_bwd_dq" if what == "flash_bwd_dq" else "flash_bwd_dkv"
            errs[key] = max(errs.get(key, 0.0), check_close(
                f"{name} {what}", a, b, dtype,
                scaled=dtype != torch.float32))
        del q, k, v, dout, out, ref, got, want
    shape = (P18_EXPERTS // P18_WORLD, 768, 3072)
    ps = [torch.randn(shape, device="cuda", generator=gen) * 0.02
          for _ in range(N_LAYER)]
    gs = [(torch.randn(shape, device="cuda", generator=gen) * 1e-3
           ).to(torch.bfloat16) for _ in range(N_LAYER)]
    m0 = [torch.randn(shape, device="cuda", generator=gen) * 1e-4
          for _ in range(N_LAYER)]
    v0 = [(torch.randn(shape, device="cuda", generator=gen) * 1e-3) ** 2
          for _ in range(N_LAYER)]
    c1, c2 = bias_corrections(0.9, 0.999, 3)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
              eps_inside_sqrt=False)
    runs = []
    for fn in (lamb_phase1, lamb_phase1_plain):
        ms, vs = [m.clone() for m in m0], [v.clone() for v in v0]
        us = [torch.empty_like(p) for p in ps]
        wsq, usq = fn(ps, gs, ms, vs, us, c1, c2, 0.5, **kw)
        torch.cuda.synchronize()
        runs.append((wsq, usq, ms, vs, us))
    tag = "phase 18 lamb_phase1 h.*.moe.expert_in_w 12 x [4, 768, 3072]"
    for what, i in (("m", 2), ("v", 3), ("u", 4)):
        if not all(torch.equal(a, b) for a, b in zip(runs[0][i], runs[1][i])):
            fail(f"{tag}: {what} is not bitwise the plain version's")
    err = 0.0
    for i in (0, 1):
        want = runs[1][i]
        err = max(err, float(((runs[0][i] - want).abs()
                              / want.abs().clamp_min(1e-30)).max()))
    log(f"  {tag}: m, v, u bitwise; block partials max rel err {err:.3e} "
        f"(tol {LAMB_RTOL:g})")
    if err > LAMB_RTOL:
        fail(f"{tag}: the block partials disagree")
    errs["lamb_phase1"] = err
    return errs


def phase_moe_and_pipeline(seed, card):
    """Phase 18. Returns ({kernel: {path: launches}}, stats)."""
    from deepspeed_tpu_torch.ops import attention as A

    t0 = time.monotonic()
    launches = {name: {} for name in launch_counters()}
    check = A._check_cuda
    shapes = p17_record_shapes()
    # (a) MoE on one rank: bf16 FusedLamb with dropout, float32 Adam, and
    # the dense model's float32 Adam (pp 1's reference)
    one = {}
    for name, kind, optimizer, precision, dropout, lr in (
            ("moe_bf16", "moe", "FusedLamb", "bf16", DROPOUT, 1e-3),
            ("moe_fp32", "moe", "Adam", "fp32", 0.0, 1e-4),
            ("dense_fp32", "dense", "Adam", "fp32", 0.0, 1e-4)):
        try:
            got = one[name] = p18_run(seed, name, kind, optimizer, precision,
                                      dropout, lr, None, shapes)
        finally:
            A._check_cuda = check
        p18_check_run(name, got, N_LAYER, P18_WINDOWS,
                      P18_WINDOWS if optimizer == "FusedLamb" else 0,
                      P18_SHAPES["moe"])
        for k, n in got["launches"].items():
            launches[k][f"p18_{name}"] = n
        if kind == "moe":
            lm, aux = got["aux"]
            if not (all(math.isfinite(v) for v in lm + aux)
                    and all(v > 0 for v in aux) and len(aux) == 1):
                fail(f"phase 18 {name}: last_aux {got['aux']}")
            log(f"  {name}: last_aux (lm, aux) {got['aux']}")
        if not got["losses"][-1] < got["losses"][0]:
            fail(f"phase 18 {name}: the loss did not fall {got['losses']}")
        shapes = p17_record_shapes()
    A._check_cuda = check
    root = Path("build") / "phase18"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ranks = p14_spawn(seed, root, timeout_s=600, flag="--phase18-rank",
                      phase="18", world=P18_WORLD)
    for rank, r in enumerate(ranks):
        for run, got in r.items():
            kind = run.split("_")[0]
            layers = N_LAYER if kind == "ep2" else N_LAYER // P18_WORLD
            per_step = 1 if kind == "ep2" else P18_MICROBATCHES
            p18_check_run(f"{run} rank {rank} (pipe, data "
                          f"{tuple(got['coords'])})", got, layers,
                          per_step * P18_WINDOWS,
                          P18_WINDOWS if "bf16" in run else 0,
                          P18_SHAPES[kind])
            for k, n in got["launches"].items():
                launches[k][f"p18_{run}_rank{rank}"] = n
            if kind == "ep2" and not (
                    all(math.isfinite(v) for a in got["aux"] for v in a)
                    and all(v > 0 for v in got["aux"][1])):
                fail(f"phase 18 {run} rank {rank}: last_aux {got['aux']}")
    for run in ranks[0]:
        if ranks[0][run]["losses"] != ranks[1][run]["losses"]:
            fail(f"phase 18 {run}: the ranks return different losses")
    p14_close("phase 18 float32 MoE ep 2 vs one rank losses",
              ranks[0]["ep2_fp32"]["losses"], one["moe_fp32"]["losses"])
    p14_close("phase 18 float32 pp 2 vs pp 1 losses",
              ranks[0]["pp2_fp32"]["losses"], one["dense_fp32"]["losses"])
    kernel_errs = p18_check_kernels(seed)
    stats = {"card": card, "one_rank": one,
             "ranks": ranks, "kernels_vs_plain": kernel_errs,
             "wall_s": time.monotonic() - t0}
    log(f"phase 18: MoE ep 2 = one rank ({ranks[0]['ep2_fp32']['losses']} "
        f"vs {one['moe_fp32']['losses']}); pp 2 = pp 1 "
        f"({ranks[0]['pp2_fp32']['losses']} vs "
        f"{one['dense_fp32']['losses']}); {stats['wall_s']:.1f} s")
    return launches, stats


# ---------------------------------------------------------------------------
# phase 19: what a sequence and model axis lifted (A7f), the flash tile
# autotuner (A7e)
# ---------------------------------------------------------------------------
P19_WORLD = 2
P19_INT8 = {"data_types": {"optimizer_state_dtype": "int8"}}
P19_INT8_COMPENSATED = {"data_types": {"optimizer_state_dtype": "int8",
                                       "master_dtype": "compensated"}}
# the runs of phase 19's two ranks at a sequence axis of 2 (GPT-2 small,
# phase 16's batches): (name, optimizer, precision, dropout, lr, config)
P19_SP_RUNS = (
    ("int8_fp32", "Adam", "fp32", 0.0, 1e-4, P19_INT8),
    ("int8_compensated_bf16", "Adam", "bf16", DROPOUT, 1e-3,
     P19_INT8_COMPENSATED),
)
# the autotuner's shapes: GPT-2 small's training shape, and D = 128
P19_TUNE_SHAPES = {"d64": TRAIN_SHAPE, "d128": FLASH_SHAPES["d128"]}
# how much slower on the device (Timer's spin reading) the autotuner's
# choice may be than the fastest form: two readings of the device clock
# (medians of 10 and a mean of 10)
P19_TUNE_SLACK = 0.05
# (b) the MoE model at a model axis of 2: its attention kernels' q shape
# (a rank's 6 of 12 heads)
P19_MOE_MP_SHAPE = (P18_ROWS, 12 // P19_WORLD, 1024, 64)
# (a) BERT-large at a sequence axis of 2, cut to 2 of its 24 layers (4
# until phase 20 came):
# Ulysses runs rows 1b-3b on a rank's 8 of 16 heads over the whole
# sequence; float32 Adam (2 windows) against sp 1, bf16 FusedLamb with
# dropout 0.1 (3 windows)
P19_BERT_LAYERS = 2
P19_BERT_SHAPE = (8, 16 // P19_WORLD, BERT_SEQ, 64)
P19_BERT_RUNS = (("fp32", "Adam", 1e-4, 2), ("bf16", "FusedLamb", BERT_LR,
                                             3))


def p19_bert(seed, sp, precision, optimizer, lr, windows):
    """BERT-large pretraining (P19_BERT_LAYERS layers, seq 512, phase 12's
    padded batches: 2 micro-steps of 8 rows a window) at a sequence axis
    of ``sp``: losses, launches (counts set to 0 just before the windows),
    LAMB's launches a step, the memory held and the peak."""
    import dataclasses

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import BertConfig, BertForPreTraining

    gc.collect()
    torch.cuda.empty_cache()
    over = {} if precision == "bf16" else dict(
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    cfg = dataclasses.replace(
        BertConfig.bert_large(max_position_embeddings=BERT_SEQ, **over),
        num_hidden_layers=P19_BERT_LAYERS)
    model = BertForPreTraining(cfg, device="cuda", seed=seed)
    config = dict(bert_config(optimizer, lr),
                  mesh={"sequence_parallel_size": sp})
    if precision != "bf16":
        del config["bf16"]
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config_params=config, rng_seed=seed)
    micro = bert_batches(seed, cfg, BERT_SEQ, "pretraining")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.monotonic()
    losses = [float(engine.train_batch(iter(micro))) for _ in range(windows)]
    torch.cuda.synchronize()
    out = {"losses": losses, "launches": read_launches(),
           "window_s": (time.monotonic() - t0) / windows,
           "held_gb": held / 1e9,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "skipped": engine.skipped_steps,
           "micro_steps": engine.micro_steps,
           "lamb_per_step": (lamb_launches_per_step(engine)
                             if optimizer == "FusedLamb" else 0)}
    del engine, model
    return out


def p19_moe_mp_engine(seed, mp):
    """initialize() on phase 18's MoE GPT-2 small (8 experts, top-2,
    capacity 1.25) at a model axis of ``mp`` with the model's Megatron
    partition_specs (dp 1: every expert on each model rank), float32
    Adam at dropout 0, one micro-step of P18_ROWS rows a window."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    gc.collect()
    torch.cuda.empty_cache()
    model = GPT2LMHeadModel(GPT2Config.small(
        dropout=0.0, moe_experts=P18_EXPERTS, moe_top_k=P18_TOP_K,
        moe_capacity_factor=P18_CAPACITY), device="cuda", seed=seed)
    cfg = p14_config("Adam", "fp32", 1, P18_ROWS, 1,
                     {"mesh": {"model_parallel_size": mp}})
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config_params=cfg,
        param_specs=(deepspeed_tpu_torch.partition_specs(model) if mp > 1
                     else None))
    return engine


def p19_sp_engine(seed, optimizer, precision, dropout, lr, sp, extra):
    """initialize() on GPT-2 small at full width and depth at a sequence
    axis of ``sp`` with the optimizer-state layout of ``extra`` (phase
    16's micro-batches and windows, ZeRO stage 0)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    gc.collect()
    torch.cuda.empty_cache()
    model = GPT2LMHeadModel(GPT2Config.small(dropout=dropout), device="cuda",
                            seed=seed)
    model.layer_config.seq_parallel_impl = "ulysses"
    cfg = p14_config(optimizer, precision, 0, P16_MICRO, 1,
                     dict(extra, mesh={"sequence_parallel_size": sp}))
    cfg["optimizer"]["params"]["lr"] = lr
    cfg.update(train_batch_size=P16_MICRO * P16_ACCUM,
               gradient_accumulation_steps=P16_ACCUM)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model,
                                                config_params=cfg)
    return engine


def phase19_rank(spec_path):
    """One of phase 19's two ranks (a subprocess) of the gloo group the
    phase makes: (a) BERT-large pretraining at a sequence axis of 2
    (float32 Adam, then bf16 FusedLamb with dropout); (b) the MoE GPT-2
    small at a model axis of 2 (float32 Adam); (c) GPT-2 small at a
    sequence axis of 2 with int8 moments
    (float32 Adam), then int8 moments with compensated masters (bf16,
    dropout). Writes its results as JSON."""
    import torch.distributed as dist

    spec = json.loads(Path(spec_path).read_text())
    rank, seed = spec["rank"], spec["seed"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{spec['port']}", rank=rank,
        world_size=P19_WORLD)
    shapes = p17_record_shapes()
    out = {}
    for precision, optimizer, lr, windows in P19_BERT_RUNS:
        shapes.clear()
        got = p19_bert(seed, P19_WORLD, precision, optimizer, lr, windows)
        got["kernel_shapes"] = sorted([n, list(s)] for n, s in shapes)
        out[f"bert_sp2_{precision}"] = got
    shapes.clear()
    engine = p19_moe_mp_engine(seed, P19_WORLD)
    got = p18_windows(engine, seed)
    got["kernel_shapes"] = sorted([n, list(s)] for n, s in shapes)
    got["coords"] = [engine.data_rank, engine.model_rank]
    out["mp2_moe_fp32"] = got
    del engine
    for name, optimizer, precision, dropout, lr, extra in P19_SP_RUNS:
        shapes.clear()
        engine = p19_sp_engine(seed, optimizer, precision, dropout, lr,
                               P19_WORLD, extra)
        got = p16_windows(engine, seed)
        got["kernel_shapes"] = sorted([n, list(s)] for n, s in shapes)
        got["coords"] = [engine.data_rank, engine.seq_rank]
        out[f"sp2_{name}"] = got
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    Path(spec["out"]).write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def p19_check_kernels(seed):
    """The attention kernels of phase 19's paths against their plain
    versions at their shapes: the MoE path's (a model rank's [8, 6, 1024,
    64], causal) in float32 as it runs them and bf16 with dropout 0.1;
    BERT's at sp 2 (a rank's [8, 8, 512, 64] after Ulysses' all-to-all,
    non-causal, the padding mask of BERT_LENGTHS) in float32 and bf16
    with dropout 0.1. Returns the max errors."""
    from deepspeed_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed + 1919)
    errs = {}
    mask = bert_mask(torch.device("cuda"), BERT_LENGTHS, BERT_SEQ)
    for tag, shape, kv_mask, causal, dtype, rate in (
            ("mp2", P19_MOE_MP_SHAPE, None, True, torch.float32, 0.0),
            ("mp2", P19_MOE_MP_SHAPE, None, True, torch.bfloat16, DROPOUT),
            ("bert sp2", P19_BERT_SHAPE, mask, False, torch.float32, 0.0),
            ("bert sp2", P19_BERT_SHAPE, mask, False, torch.bfloat16,
             DROPOUT)):
        q, k, v, dout = (torch.randn(shape, device="cuda",
                                     generator=gen).to(dtype)
                         for _ in range(4))
        args = (q, k, v, kv_mask, causal, None, rate, 1919)
        out, _ = A.flash_fwd(*args)
        ref, ref_lse = A.flash_fwd_plain(*args)
        name = f"phase 19 {tag} {str(dtype)[6:]} {list(shape)}"
        errs["flash_fwd"] = max(errs.get("flash_fwd", 0.0), check_close(
            f"{name} flash_fwd", out, ref, dtype))
        delta = (dout.float() * ref.float()).sum(dim=-1)
        bargs = (q, k, v, kv_mask, dout, ref_lse, delta, causal, None, rate,
                 1919)
        got = (A.flash_bwd_dq(*bargs), *A.flash_bwd_dkv(*bargs))
        want = (A.flash_bwd_dq_plain(*bargs), *A.flash_bwd_dkv_plain(*bargs))
        for what, a, b in zip(("flash_bwd_dq", "dk", "dv"), got, want):
            key = "flash_bwd_dq" if what == "flash_bwd_dq" else "flash_bwd_dkv"
            errs[key] = max(errs.get(key, 0.0), check_close(
                f"{name} {what}", a, b, dtype,
                scaled=dtype != torch.float32))
        del q, k, v, dout, out, ref, got, want
    return errs


def p19_autotune(seed):
    """(d) The flash tile autotuner at GPT-2 small's training shape and at
    D = 128 (bf16, causal, forward and backward): its table; each tile
    form of the forward against the plain version (phase 3's tolerances,
    dropout 0.1) and timed by Timer (``ms``, and ``device_ms`` behind a
    spin), beside the bound; fails if the autotuner's choice is more than
    P19_TUNE_SLACK slower on the device than the fastest form. Returns
    {shape: entry}."""
    from deepspeed_tpu_torch.ops import attention as A
    from deepspeed_tpu_torch.ops.autotune import autotune_flash_blocks

    timer = Timer(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    out = {}
    for tag, shape in P19_TUNE_SHAPES.items():
        best, table = autotune_flash_blocks(*shape, causal=True,
                                            dtype=torch.bfloat16, steps=10)
        log(f"  autotune {tag} {list(shape)}: best {best}; "
            + ", ".join(f"{bq}x{bk} {t * 1e3:.4f} ms (fwd+bwd, device)"
                        for (bq, bk), t in sorted(table.items())))
        q, k, v = (torch.randn(shape, device="cuda", generator=gen
                               ).to(torch.bfloat16) for _ in range(3))
        args = (q, k, v, None, True, None, DROPOUT, 1919)
        ref, ref_lse = A.flash_fwd_plain(*args)
        nbytes, flops = flash_work(q, None, True, "fwd")
        b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
        forms = {}
        for bq, bk in A.flash_block_forms(torch.bfloat16, shape[-1]):
            o, lse = A.flash_fwd(*args, block_k=bk)
            name = f"phase 19 flash_fwd {bq}x{bk} {list(shape)}"
            err = check_close(name, o, ref, torch.bfloat16)
            rows = ref_lse > -1e29
            check_close(f"{name} lse", lse[rows], ref_lse[rows],
                        torch.float32)
            call = lambda bq=bq, bk=bk: A.flash_fwd(
                q, k, v, None, True, block_k=bk)
            forms[f"{bq}x{bk}"] = dict(
                max_abs_err=err, ms=timer.ms(call, iters=10),
                device_ms=timer.ms(call, iters=10, spin=True,
                                   spin_cycles=20_000_000))
            log(f"  {name}: {forms[f'{bq}x{bk}']['ms']:.5f} ms, device "
                f"{forms[f'{bq}x{bk}']['device_ms']:.5f} ms (bound "
                f"{b_ms:.5f} ms, {b_by})")
        chosen = f"{best[0]}x{best[1]}"
        fastest = min(forms, key=lambda f: forms[f]["device_ms"])
        log(f"  autotune {tag}: chose {chosen}, Timer's device ms rank "
            f"{fastest} first")
        if (forms[chosen]["device_ms"]
                > (1 + P19_TUNE_SLACK) * forms[fastest]["device_ms"]):
            fail(f"phase 19 autotune {tag} chose {chosen}, "
                 f"{forms[chosen]['device_ms']:.5f} ms on the device, where "
                 f"{fastest} takes {forms[fastest]['device_ms']:.5f} ms")
        out[tag] = {"shape": list(shape), "best": list(best),
                    "table_s": {f"{bq}x{bk}": t
                                for (bq, bk), t in table.items()},
                    "forms": forms, "bound_ms": b_ms, "bound_by": b_by}
        del q, k, v, ref, ref_lse
    return out


def phase_parallel_lifted_and_autotune(seed, card):
    """Phase 19. Returns ({kernel: {path: launches}}, stats)."""
    t0 = time.monotonic()
    root = Path("build") / "phase19"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ranks = p14_spawn(seed, root, timeout_s=600, flag="--phase19-rank",
                      phase="19", world=P19_WORLD)
    launches = {name: {} for name in launch_counters()}
    micro_steps = P16_WINDOWS * P16_ACCUM
    # (a) BERT-large at a sequence axis of 2
    for rank, r in enumerate(ranks):
        for precision, _, _, windows in P19_BERT_RUNS:
            run = f"bert_sp2_{precision}"
            got = r[run]
            if not all(math.isfinite(v) for v in got["losses"]) or got[
                    "skipped"]:
                fail(f"phase 19 rank {rank} {run}: losses {got['losses']}")
            want = P19_BERT_LAYERS * got["micro_steps"]
            for kname in TRAIN_KERNELS:
                if got["launches"][kname] != want:
                    fail(f"phase 19 rank {rank} {run}: {kname} launched "
                         f"{got['launches'][kname]} times, want {want}")
            if got["launches"]["lamb_phase1"] != got["lamb_per_step"] * (
                    windows):
                fail(f"phase 19 rank {rank} {run}: lamb_phase1 launched "
                     f"{got['launches']['lamb_phase1']} times")
            shapes = {tuple(s) for _, s in got["kernel_shapes"]}
            if shapes != {P19_BERT_SHAPE}:
                fail(f"phase 19 rank {rank} {run}: attention kernels at "
                     f"{sorted(shapes)}, want {P19_BERT_SHAPE}")
            for kname, n in got["launches"].items():
                launches[kname][f"p19_{run}_rank{rank}"] = n
            log(f"  BERT-large ({P19_BERT_LAYERS} layers) sp 2 {precision} "
                f"rank {rank}: losses {got['losses']}; held "
                f"{got['held_gb']:.4f} GB, peak {got['peak_gb']:.4f} GB; "
                f"{got['window_s']:.3f} s a window; launches "
                + ", ".join(f"{k} {got['launches'][k]}" for k in
                            (*TRAIN_KERNELS, "lamb_phase1")))
    bert_bf16 = ranks[0]["bert_sp2_bf16"]["losses"]
    if not bert_bf16[-1] < bert_bf16[0]:
        fail("phase 19 BERT-large bf16 at sp 2: the loss did not fall "
             f"{bert_bf16}")
    precision, optimizer, lr, windows = P19_BERT_RUNS[0]
    bert_ref = p19_bert(seed, 1, precision, optimizer, lr, windows)
    p14_close("phase 19 float32 BERT-large sp 2 vs sp 1 losses",
              ranks[0]["bert_sp2_fp32"]["losses"], bert_ref["losses"])
    # (b) the MoE model at a model axis of 2
    for rank, r in enumerate(ranks):
        got = r["mp2_moe_fp32"]
        p18_check_run(f"phase 19 MoE mp 2 rank {rank} (model rank "
                      f"{got['coords'][1]})", got, N_LAYER, P18_WINDOWS, 0,
                      P19_MOE_MP_SHAPE)
        for kname, n in got["launches"].items():
            launches[kname][f"p19_mp2_moe_fp32_rank{rank}"] = n
    if ranks[0]["mp2_moe_fp32"]["losses"] != ranks[1]["mp2_moe_fp32"][
            "losses"]:
        fail("phase 19 MoE mp 2: the model ranks return different losses")
    engine = p19_moe_mp_engine(seed, 1)
    moe_ref = p18_windows(engine, seed)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    p14_close("phase 19 float32 MoE mp 2 vs one rank losses",
              ranks[0]["mp2_moe_fp32"]["losses"], moe_ref["losses"])
    # (c) int8 moments (and compensated masters) at a sequence axis of 2
    for rank, r in enumerate(ranks):
        for run, got in r.items():
            if not run.startswith("sp2_"):
                continue
            if not all(math.isfinite(v) for v in got["losses"]) or got[
                    "skipped"]:
                fail(f"phase 19 rank {rank} {run}: losses {got['losses']}")
            for kname in TRAIN_KERNELS:
                if got["launches"][kname] != N_LAYER * micro_steps:
                    fail(f"phase 19 rank {rank} {run}: {kname} launched "
                         f"{got['launches'][kname]} times, want "
                         f"{N_LAYER * micro_steps}")
            shapes = {tuple(s) for _, s in got["kernel_shapes"]}
            if shapes != {P17_UL_SHAPE}:
                fail(f"phase 19 rank {rank} {run}: attention kernels at "
                     f"{sorted(shapes)}, want {P17_UL_SHAPE}")
            for kname, n in got["launches"].items():
                launches[kname][f"p19_{run}_rank{rank}"] = n
            log(f"  {run} rank {rank} (sequence rank {got['coords'][1]}): "
                f"losses {got['losses']}; held {got['held_gb']:.4f} GB, "
                f"peak {got['peak_gb']:.4f} GB; {got['window_s']:.3f} s a "
                "window (two ranks on one card over gloo: not an sp 2 "
                "speed); launches "
                + ", ".join(f"{k} {got['launches'][k]}" for k in
                            (*TRAIN_KERNELS, "lamb_phase1")))
    for run in ranks[0]:
        if ranks[0][run]["losses"] != ranks[1][run]["losses"]:
            fail(f"phase 19 {run}: the ranks return different losses")
    bf16 = ranks[0]["sp2_int8_compensated_bf16"]["losses"]
    if not bf16[-1] < bf16[0]:
        fail(f"phase 19 int8 + compensated bf16 at sp 2: the loss did not "
             f"fall {bf16}")
    name, optimizer, precision, dropout, lr, extra = P19_SP_RUNS[0]
    engine = p19_sp_engine(seed, optimizer, precision, dropout, lr, 1, extra)
    ref = p16_windows(engine, seed)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    p14_close("phase 19 float32 int8 moments sp 2 vs sp 1 losses",
              ranks[0]["sp2_int8_fp32"]["losses"], ref["losses"])
    kernel_errs = p19_check_kernels(seed)
    # (d) the autotuner and the forward's tile forms
    tune = p19_autotune(seed)
    stats = {"card": card, "ranks": ranks,
             "bert_fp32_sp1": {k: bert_ref[k] for k in
                               ("losses", "held_gb", "peak_gb")},
             "moe_fp32_mp1": {k: moe_ref[k] for k in
                              ("losses", "held_gb", "peak_gb", "params_m",
                               "weights_gb")},
             "int8_fp32_sp1": {k: ref[k] for k in
                               ("losses", "held_gb", "peak_gb")},
             "kernels_vs_plain": kernel_errs,
             "autotune": tune, "wall_s": time.monotonic() - t0}
    log(f"phase 19: float32 BERT-large sp 2 = sp 1 "
        f"({ranks[0]['bert_sp2_fp32']['losses']} vs {bert_ref['losses']}); "
        f"bf16 {bert_bf16}; float32 MoE mp 2 = one rank "
        f"({ranks[0]['mp2_moe_fp32']['losses']} vs {moe_ref['losses']}); "
        f"float32 int8 sp 2 = sp 1 "
        f"({ranks[0]['sp2_int8_fp32']['losses']} vs {ref['losses']}); "
        f"int8 + compensated bf16 {bf16}; autotune best "
        + ", ".join(f"{t} {e['best']}" for t, e in tune.items())
        + f"; {stats['wall_s']:.1f} s")
    return launches, stats


# ---------------------------------------------------------------------------
# phase 20: the serving fleet on one host (serving/)
# ---------------------------------------------------------------------------
P20_REPLICAS = 2
P20_PREFILL = 256   # the cold prefill's window, so that it takes the flash forward
P20_MAX_SEQ = 512
P20_NEW = 24
P20_AFFINITY = 32   # prompt tokens prefix affinity hashes (2 pages)
P20_TEMPLATES = (48, 32, 48, 32)  # shared prefixes: 3 or 2 pages of 16
P20_SERIAL = 2      # requests of (e) and of (a)'s one-at-a-time round trips
P20_STREAMS = 2     # (f)'s SSE streams
P20_CLIENTS = 8     # (b)'s client threads, 2 requests each
P20_BROWNOUT = {"queue_ratio": 0.25, "max_new_tokens": 4}
P20_LOAD_NEW = 96   # (c)'s load: new tokens a request
P20_ADAPTERS = {"0": ("a", "b"), "1": ("c", "d")}
# the fleet's own ways to hide a failure, each expected 0 unless the
# sub-phase causes it
P20_HIDDEN = ("fleet/replicas_evicted", "fleet/requests_rerouted",
              "fleet/breaker_opens", "fleet/zombie_restarts")


def p20_block(dtype, **extra):
    block = {"max_batch_slots": INF_SLOTS, "max_seq_len": P20_MAX_SEQ,
             "prefill_len": P20_PREFILL, "kv_block_size": 16,
             "fused_decode": True, "dtype": dtype,
             "sampling": {"greedy": True}}
    block.update(extra)
    return block


def p20_factory(model, dtype, extra=None, **inference):
    """An engine factory over ``model`` (each call a fresh engine, as the
    fleet's replicas and their restarts build them)."""
    import deepspeed_tpu_torch

    def build():
        return deepspeed_tpu_torch.init_inference(
            model=model, config={"inference": p20_block(dtype, **inference),
                                 **(extra or {})})

    return build


def p20_prompts(seed, vocab):
    """16 prompts: 4 templates of 2-3 pages with 3 tails each, then 4 of
    their own, interleaved so that a template's later requests follow
    its first."""
    g = torch.Generator().manual_seed(seed + 200)
    heads = [random_tokens(g, n, vocab) for n in P20_TEMPLATES]
    templated = [[h + random_tokens(g, k, vocab) for h in heads]
                 for k in (5, 11, 17)]
    own = [random_tokens(g, n, vocab) for n in (9, 40, 77, 120)]
    return [p for row in templated for p in row] + own


def p20_engines(router):
    return [router._replicas[rid].engine for rid in router.replica_ids]


def p20_clean(tag, router, reqs, restarts=0):
    """Nothing hid a failure: no eviction, reroute, breaker open or zombie
    restart, ``restarts`` replica restarts, every request finished with its
    budget, and (in process) on a replica whose engine runs on the card.
    Returns the fleet's metrics snapshot."""
    router.refresh_telemetry()
    snap = router.metrics.snapshot()
    for key in P20_HIDDEN:
        if snap[key]:
            fail(f"{tag}: {key} = {snap[key]}: the router hid a replica's "
                 "failure")
    if snap["fleet/replica_restarts"] != restarts:
        fail(f"{tag}: {snap['fleet/replica_restarts']} replica restarts, "
             f"expected {restarts}")
    if router.evicted_ids:
        fail(f"{tag}: replicas {sorted(router.evicted_ids)} evicted")
    for r in reqs:
        if r.reroutes or r.finish_reason != "max_new_tokens":
            fail(f"{tag}: request {r.request_id} finished "
                 f"{r.finish_reason!r} after {r.reroutes} reroutes")
        engine = getattr(router._replicas[r.replica_id], "engine", None)
        if engine is not None and torch.device(engine.device).type != "cuda":
            fail(f"{tag}: replica {r.replica_id} serves on {engine.device}")
    return snap


def p20_fleet_stats(router, wall):
    st = [engine_stats(e, wall) for e in p20_engines(router)]
    total = {k: sum(s[k] for s in st) for k in
             ("cold_prefills", "prefix_hits", "decode_steps",
              "decode_ms_sum", "tokens", "requests")}
    total["wall_s"] = wall
    return total


def p20_check_launches(tag, got, st, sgmv=False):
    """The fleet's launches equal its engines' own counts: the flash
    forward 12 a cold prefill, paged decode (and SGMV's 4 targets) 12 a
    decode step."""
    want = {"flash_fwd": N_LAYER * st["cold_prefills"],
            "paged_decode": N_LAYER * st["decode_steps"]}
    if sgmv:
        want["sgmv"] = 4 * N_LAYER * st["decode_steps"]
    for name, n in want.items():
        if got.get(name, 0) != n or n <= 0:
            fail(f"{tag}: {name} launched {got.get(name, 0)} times through the "
                 f"fleet, its engines count {n} ({st})")


def p20_serial_ms(router, prompts):
    """Mean wall ms a request, one at a time, prompt to last token; and
    the requests."""
    t0 = time.monotonic()
    reqs = []
    for p in prompts:
        reqs.append(router.submit(p, max_new_tokens=P20_NEW))
        reqs[-1].result(300.0)
    torch.cuda.synchronize()
    return (time.monotonic() - t0) * 1e3 / len(prompts), reqs


def p20_fleet(model, dtype, prompts, vocab, card):
    """(a) one dtype: the fleet's tokens against one engine's, the
    launches against the engines' counts. Returns (router, stats,
    launches, reference tokens); the caller shuts the router down."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.telemetry.manager import SERVING_METRICS

    tag = f"phase 20(a) {dtype}"
    held = torch.cuda.memory_allocated()
    single = p20_factory(model, dtype)()
    engine_bytes = torch.cuda.memory_allocated() - held
    try:
        want = single.generate(prompts, max_new_tokens=P20_NEW)
    finally:
        single.close()
        del single
    torch.cuda.synchronize()
    router = deepspeed_tpu_torch.init_fleet(
        engine_factory=p20_factory(model, dtype),
        config={"serving": {"replicas": P20_REPLICAS,
                            "placement": "prefix_affinity",
                            "affinity_prefix_tokens": P20_AFFINITY}})
    zero_launches()
    t0 = time.monotonic()
    reqs = [router.submit(p, max_new_tokens=P20_NEW) for p in prompts]
    got = [r.result(300.0) for r in reqs]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_launches()
    st = p20_fleet_stats(router, wall)
    if dtype == "fp32":
        same_tokens(tag, prompts, got, want, model, vocab)
        flip = None
    else:
        flip = bf16_divergence(tag, prompts, got, want, model, vocab)
    snap = p20_clean(tag, router, reqs)
    p20_check_launches(tag, launches, st)
    if snap["fleet/affinity_hits"] <= 0:
        fail(f"{tag}: no affinity hit")
    missing = [name for _, name, _ in SERVING_METRICS
               if name not in snap and f"{name}/count" not in snap]
    if missing:
        fail(f"{tag}: fleet/* streams missing: {missing}")
    served = {r.replica_id for r in reqs}
    stats = {
        "card": card, "requests": len(reqs), "replicas_serving":
        sorted(served), "ttft_p50_ms": snap["fleet/ttft_p50_ms"],
        "ttft_p99_ms": snap["fleet/ttft_p99_ms"],
        "affinity_hits": snap["fleet/affinity_hits"],
        "prefix_hits": st["prefix_hits"], "cold_prefills":
        st["cold_prefills"], "decode_steps": st["decode_steps"],
        "tokens_per_s": st["tokens"] / wall,
        "engine_decode_tokens_per_s": (st["tokens"] - st["requests"])
        / (st["decode_ms_sum"] / 1e3),
        "wall_s": wall, "engine_bytes": engine_bytes, "bf16_flip": flip,
    }
    log(f"  {tag}: {len(reqs)} requests on replicas {sorted(served)}, "
        f"TTFT p50 {stats['ttft_p50_ms']:.3f} ms p99 "
        f"{stats['ttft_p99_ms']:.3f} ms, {stats['tokens_per_s']:.1f} "
        f"tokens/s over the fleet's wall, "
        f"{stats['engine_decode_tokens_per_s']:.1f} tokens/s over the "
        f"engines' decode steps, affinity hits "
        f"{stats['affinity_hits']}, prefix hits {st['prefix_hits']}, "
        f"launches {launches} ({card})")
    return router, stats, launches, want


def p20_restart(router, prompts, want, model, vocab, card):
    """(b) a rolling restart under traffic at capacity_floor 0.5: every
    request answered exactly once with the single engine's tokens, never
    fewer than one routable replica; the card's peak while the replicas
    rebuild."""
    import threading

    tag = "phase 20(b) rolling restart"
    available = router.metrics.gauge("fleet/replicas_available")
    results, errors, floor = {}, [], []
    torch.cuda.synchronize()
    completed = router.metrics.counter("fleet/requests_completed").value
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()

    def client(i):
        for j in (i, i + P20_CLIENTS):
            try:
                req = router.submit(prompts[j], max_new_tokens=P20_NEW)
                results.setdefault(j, []).append(req)
                req.result(300.0)
            except Exception as e:
                errors.append((j, repr(e)))

    watching = threading.Event()

    def watch():
        while not watching.is_set():
            if available.value < 1.0:
                floor.append(available.value)
            time.sleep(0.001)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(P20_CLIENTS)]
    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    t0 = time.monotonic()
    for t in threads:
        t.start()
    router.rolling_restart(wait_timeout=120.0)
    for t in threads:
        t.join(300.0)
    watching.set()
    watcher.join(5.0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    after = torch.cuda.memory_allocated()
    if errors:
        fail(f"{tag}: {errors}")
    if sorted(results) != list(range(len(prompts))) or any(
            len(v) != 1 for v in results.values()):
        fail(f"{tag}: not every request answered exactly once "
             f"({ {j: len(v) for j, v in results.items()} })")
    reqs = [results[j][0] for j in range(len(prompts))]
    same_tokens(tag, prompts, [r.tokens for r in reqs], want, model, vocab)
    if floor:
        fail(f"{tag}: fleet/replicas_available fell to {min(floor)} under "
             "the floor of 1")
    snap = p20_clean(tag, router, reqs, restarts=P20_REPLICAS)
    if snap["fleet/requests_completed"] - completed != len(reqs):
        fail(f"{tag}: {snap['fleet/requests_completed'] - completed} "
             f"completions for {len(reqs)} requests")
    for name in ("flash_fwd", "paged_decode"):
        if launches[name] <= 0:
            fail(f"{tag}: {name} launched no time ({launches})")
    stats = {"card": card, "requests": len(reqs), "wall_s": wall,
             "held_before_gb": before / 1e9, "peak_gb": peak / 1e9,
             "held_after_gb": after / 1e9,
             "peak_over_before_gb": (peak - before) / 1e9}
    log(f"  {tag}: {len(reqs)} requests from {P20_CLIENTS} clients "
        f"answered once each in {wall:.2f} s; card memory {before / 1e9:.3f}"
        f" GB before, peak {peak / 1e9:.3f} GB, {after / 1e9:.3f} GB after; "
        f"launches {launches} ({card})")
    return stats, launches


def p20_door(router, prompts, want, card):
    """(f) serve_http on 127.0.0.1:0 in front of (a)'s float32 router:
    P20_STREAMS SSE streams, each token its own event, the first event
    before the request's last token, the tokens (a)'s."""
    import socket

    from deepspeed_tpu_torch.serving import serve_http

    tag = "phase 20(f) HTTP door"
    door = serve_http(router, host="127.0.0.1", port=0)
    host, port = door.address
    engines = p20_engines(router)
    out = []
    zero_launches()
    try:
        for j in range(P20_STREAMS):
            body = json.dumps({"prompt": prompts[j], "stream": True,
                               "max_new_tokens": P20_NEW}).encode()
            sock = socket.create_connection((host, port))
            sock.settimeout(120.0)
            t0 = time.monotonic()
            sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: door\r\n"
                         b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
            buf, first_at, live = b"", None, None
            while b"event: done" not in buf:
                chunk = sock.recv(65536)
                if not chunk:
                    break
                buf += chunk
                if first_at is None and b"event: token" in buf:
                    first_at = time.monotonic() - t0
                    live = sum(len(e.scheduler.active_slots)
                               for e in engines)
            done_at = time.monotonic() - t0
            sock.close()
            tokens, done = [], None
            for block in buf.split(b"\n\n"):
                if b"event: token" in block:
                    tokens.append(json.loads(block.split(b"data: ", 1)[1]))
                elif b"event: done" in block:
                    done = json.loads(block.split(b"data: ", 1)[1])
            if not buf.startswith(b"HTTP/1.1 200") or done is None:
                fail(f"{tag}: stream {j}: {buf[:300]!r}")
            if [t["t"] for t in tokens] != want[j] or done["tokens"] != \
                    want[j]:
                fail(f"{tag}: stream {j} streamed {[t['t'] for t in tokens]}"
                     f", done {done['tokens']}, (a) {want[j]}")
            if not live:
                fail(f"{tag}: stream {j}'s first event came after its "
                     "request left its slot")
            out.append({"first_event_s": first_at, "done_s": done_at})
    finally:
        door.shutdown()
    launches = read_launches()
    log(f"  {tag}: {P20_STREAMS} streams of {P20_NEW} token events, first "
        f"event at {[round(o['first_event_s'] * 1e3, 3) for o in out]} ms, "
        f"done at {[round(o['done_s'] * 1e3, 3) for o in out]} ms; launches "
        f"{launches} ({card})")
    return {"card": card, "streams": out}, launches


def p20_brownout(model, vocab, seed, card):
    """(c) between the thresholds sheddable requests are clamped to
    brownout_max_new_tokens and the engines stop registering prefixes
    while their hits go on. The router's periodic refresh is off, so the
    band holds from the submit that enters it to the explicit refresh
    that leaves it."""
    from deepspeed_tpu_torch.serving import FleetRouter, InProcessReplica

    tag = "phase 20(c) brownout"
    g = torch.Generator().manual_seed(seed + 201)
    template = random_tokens(g, 48, vocab)
    fresh = random_tokens(g, 48, vocab)
    factory = p20_factory(model, "bf16", max_batch_slots=2, queue_depth=8)
    router = FleetRouter(
        [InProcessReplica(str(i), factory) for i in range(P20_REPLICAS)],
        placement="prefix_affinity", affinity_prefix_tokens=P20_AFFINITY,
        shed_queue_ratio=0.9,
        brownout_queue_ratio=P20_BROWNOUT["queue_ratio"],
        brownout_max_new_tokens=P20_BROWNOUT["max_new_tokens"],
        telemetry_refresh_secs=3600.0).start()
    try:
        engines = p20_engines(router)

        def counts():
            snaps = [e.metrics.snapshot() for e in engines]
            return (sum(s["infer/prefix_hits"] for s in snaps),
                    sum(s["infer/prefix_misses"] for s in snaps),
                    sum(len(e.block_pool._registry) for e in engines))

        router.submit(template + random_tokens(g, 7, vocab),
                      max_new_tokens=4).result(300.0)
        before = counts()
        zero_launches()
        # 8 long requests with prompts under a page (nothing to register
        # at prefill) fill the 4 slots and queue 4: fill 4/16 = 0.25
        load = [router.submit(random_tokens(g, 8, vocab),
                              max_new_tokens=P20_LOAD_NEW)
                for _ in range(8)]
        hit = router.submit(template + random_tokens(g, 9, vocab),
                            priority=1, max_new_tokens=32)
        cold = router.submit(fresh + random_tokens(g, 9, vocab),
                             priority=1, max_new_tokens=32)
        full = router.submit(random_tokens(g, 40, vocab), priority=0,
                             max_new_tokens=8)
        if not router.brownout:
            fail(f"{tag}: the fleet did not enter brownout")
        reqs = load + [hit, cold, full]
        for r in reqs:
            r.result(300.0)
        torch.cuda.synchronize()
        during = counts()
        launches = read_launches()
        if not router.brownout:
            fail(f"{tag}: the fleet left brownout without a refresh")
        clamped = [r.kwargs["max_new_tokens"] for r in (hit, cold, full)]
        lengths = [len(r.tokens) for r in (hit, cold, full)]
        if clamped != [4, 4, 8] or lengths != [4, 4, 8]:
            fail(f"{tag}: budgets {clamped}, tokens {lengths}; expected the "
                 "two priority-1 requests clamped to 4, priority 0 at 8")
        if during[2] != before[2]:
            fail(f"{tag}: {during[2] - before[2]} prefix pages registered "
                 "under brownout")
        if during[0] <= before[0]:
            fail(f"{tag}: the template's hit was not served under brownout "
                 f"(prefix hits {before[0]} -> {during[0]})")
        router.refresh_telemetry()  # empty queues: leave the band
        if router.brownout:
            fail(f"{tag}: the fleet stayed in brownout with empty queues")
        after_req = router.submit(fresh + random_tokens(g, 3, vocab),
                                  priority=1, max_new_tokens=8)
        after_req.result(300.0)
        after = counts()
        if len(after_req.tokens) != 8 or after[2] <= during[2] \
                or after[1] <= during[1]:
            fail(f"{tag}: after brownout the fresh template should miss and "
                 f"register (counts {during} -> {after}, "
                 f"{len(after_req.tokens)} tokens)")
        snap = p20_clean(tag, router, reqs + [after_req])
        if snap["fleet/requests_browned_out"] != 2:
            fail(f"{tag}: fleet/requests_browned_out "
                 f"{snap['fleet/requests_browned_out']}, expected 2")
    finally:
        router.shutdown()
    stats = {"card": card, "hits_misses_registered_before": before,
             "during": during, "after": after}
    log(f"  {tag}: prefix hits, misses, registered pages {before} before, "
        f"{during} under brownout, {after} after; budgets {clamped}; "
        f"launches {launches} ({card})")
    return stats, launches


def p20_adapters(model, vocab, seed, card):
    """(d) two replicas each load two synthetic rank-16 adapters; with
    adapter affinity every adapter request lands on its holder, SGMV
    launches 48 times a decode step, and the float32 tokens equal one
    engine's with the same adapters."""
    import deepspeed_tpu_torch

    tag = "phase 20(d) multi-LoRA"
    base = {k: v for k, v in model.state_dict().items()}
    states = {n: synthetic_adapter(base, seed + 210 + i)
              for i, n in enumerate(("a", "b", "c", "d"))}
    extra = {"adapters": {"enabled": True, "rank": LORA_RANK,
                          "pool_slots": LORA_POOL_SLOTS}}
    g = torch.Generator().manual_seed(seed + 202)
    prompts = [random_tokens(g, n, vocab) for n in (12, 40, 77, 25, 60, 33,
                                                    90, 18)]
    names = ["a", "c", "b", "d", None, "a", "d", None]
    single = p20_factory(model, "fp32", extra)()
    try:
        for n, s in states.items():
            single.load_adapter(n, adapter_state=s)
        want, _ = run_batch(single, prompts, names, P20_NEW)
    finally:
        single.close()
        del single
    router = deepspeed_tpu_torch.init_fleet(
        engine_factory=p20_factory(model, "fp32", extra),
        config={"serving": {"replicas": P20_REPLICAS,
                            "placement": "adapter_affinity"}})
    try:
        for rid, held in P20_ADAPTERS.items():
            for n in held:
                router.load_adapter(n, replica_ids=[rid],
                                    adapter_state=states[n])
        holder = {n: rid for rid, held in P20_ADAPTERS.items()
                  for n in held}
        zero_launches()
        t0 = time.monotonic()
        reqs = [router.submit(p, max_new_tokens=P20_NEW, adapter=n)
                for p, n in zip(prompts, names)]
        got = [r.result(300.0) for r in reqs]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = read_launches()
        st = p20_fleet_stats(router, wall)
        for r, n in zip(reqs, names):
            if n is not None and r.replica_id != holder[n]:
                fail(f"{tag}: adapter {n} served by replica {r.replica_id}, "
                     f"held by {holder[n]}")
        same_tokens(tag, prompts, got, want, model, vocab)
        p20_check_launches(tag, launches, st, sgmv=True)
        p20_clean(tag, router, reqs)
    finally:
        router.shutdown()
    log(f"  {tag}: adapters {P20_ADAPTERS} over 2 replicas, {len(reqs)} "
        f"requests; launches {launches} ({card})")
    return {"card": card, "wall_s": wall, **st}, launches


def p20_checkpoint(model, root):
    """The fleet's weights through the port's checkpoint: a CPU copy of
    the model in a training engine (SGD, nothing trained) saves them."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    cpu = GPT2LMHeadModel(GPT2Config.small(dropout=0.0), device="cpu")
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=cpu,
        model_parameters={k: v.cpu() for k, v in model.state_dict().items()},
        config_params={"train_batch_size": 1,
                       "optimizer": {"type": "SGD", "params": {"lr": 0.0}}},
        device="cpu")
    engine.save_checkpoint(str(root))


def p20_worker(model, prompts, want, serial_ms, card, root):
    """(e) the subprocess backend: one worker process builds GPT-2 small
    on the card from the checkpoint and serves (a)'s first prompts (after
    one untimed request); its float32 tokens equal (a)'s, and shutdown
    reaps it. The worker's launches, which it logs at exit, equal its
    engine's counts over its life, read from the worker before shutdown:
    the flash forward 12 a cold prefill, paged decode 12 a decode step.
    The worker's stderr (its log) goes to a file, printed on failure.
    Returns (stats, the worker's launches)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.telemetry.registry import wire_scalars

    tag = "phase 20(e) subprocess worker"
    t0 = time.monotonic()
    p20_checkpoint(model, root / "ckpt")
    save_s = time.monotonic() - t0
    spec = {"model": {}, "config": {"inference": dict(
        p20_block("fp32"), checkpoint={"load_dir": str(root / "ckpt")})}}
    log_path = root / "worker.log"
    saved = os.dup(2)
    with open(log_path, "w") as f:
        os.dup2(f.fileno(), 2)
        try:
            t0 = time.monotonic()
            router = deepspeed_tpu_torch.init_fleet(
                worker_spec=spec,
                config={"serving": {"backend": "subprocess",
                                    "replicas": 1}})
            start_s = time.monotonic() - t0
        except Exception as e:
            os.dup2(saved, 2)
            log(log_path.read_text()[-4000:])
            fail(f"{tag}: the worker did not start: {e!r}")
        finally:
            os.dup2(saved, 2)
            os.close(saved)
    replica = router._replicas["0"]
    proc = replica._proc
    try:
        # the worker's first request pays its process's first launches
        # (in process, (a) paid them): not timed
        warm = router.submit(prompts[P20_SERIAL], max_new_tokens=P20_NEW)
        if warm.result(300.0) != want[P20_SERIAL]:
            log(log_path.read_text()[-4000:])
            fail(f"{tag}: the warm-up request's tokens differ from (a)'s")
        ms, reqs = p20_serial_ms(router, prompts[:P20_SERIAL])
        got = [r.tokens for r in reqs]
        reqs_ok = got == want[:P20_SERIAL]
        snap = p20_clean(tag, router, reqs)
        counts = wire_scalars(
            replica._call({"op": "metrics_snapshot"})["metrics"])
    finally:
        router.shutdown()
    text = log_path.read_text()
    if proc.poll() is None:
        fail(f"{tag}: the worker process was not reaped")
    if not reqs_ok:
        log(text[-4000:])
        fail(f"{tag}: tokens {got} differ from (a)'s {want[:P20_SERIAL]}")
    if "dtype fp32 on cuda" not in text:
        log(text[-4000:])
        fail(f"{tag}: the worker's engine did not report serving on cuda")
    mark = "worker: kernel launches "
    lines = [ln for ln in text.splitlines() if ln.startswith(mark)]
    if len(lines) != 1:
        log(text[-4000:])
        fail(f"{tag}: the worker logged {len(lines)} launch lines")
    launches = json.loads(lines[0][len(mark):])
    st = {"cold_prefills": int(counts["infer/prefix_misses"]),
          "decode_steps": int(counts["infer/token_latency_ms/count"])}
    p20_check_launches(tag, launches, st)
    stats = {"card": card, "checkpoint_save_s": save_s,
             "worker_start_s": start_s, "ms_a_request": ms,
             "in_process_ms_a_request": serial_ms,
             "requests_completed": snap["fleet/requests_completed"],
             "launches": launches, **st}
    log(f"  {tag}: checkpoint saved in {save_s:.2f} s, worker ready in "
        f"{start_s:.2f} s; {ms:.3f} ms a request one at a time, against "
        f"{serial_ms:.3f} ms in process ({card}); the worker's launches "
        f"over its life {launches}, its engine's cold prefills "
        f"{st['cold_prefills']}, decode steps {st['decode_steps']}")
    return stats, launches


def p20_check_kernels(seed, phase=20, sgmv=True):
    """Each kernel of phase 20's paths (and of phase 21's, which serve the
    same engines from a node agent) against its plain version at the
    shapes the fleet's engines give it, float32 and bf16: the flash
    forward at the cold prefill's [1, 12, P20_PREFILL, 64] (causal, no
    mask, as the engine calls it; and with the prompt's padding keys
    masked), paged decode at INF_SLOTS slots over P20_MAX_SEQ / 16 pages
    a slot, and with ``sgmv`` SGMV (its delta and the epilogue form
    decode runs) at rank 16 over 4 adapters on each target. Returns the
    max errors."""
    from deepspeed_tpu_torch.ops import attention as A
    from deepspeed_tpu_torch.ops.decode_attention import (
        lora_sgmv,
        lora_sgmv_plain,
        paged_flash_decode,
        paged_flash_decode_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed + phase)
    shape = (1, 12, P20_PREFILL, 64)
    padded = torch.ones(1, P20_PREFILL, dtype=torch.int32, device="cuda")
    padded[0, 77:] = 0
    page, heads = 16, 12
    mb = P20_MAX_SEQ // page
    pages = INF_SLOTS * mb + 1
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                   for _ in range(3))
        for case, mask in (("causal", None), ("causal+padding", padded)):
            args = (q, k, v, mask, True)
            key = f"flash_fwd {name}"
            errs[key] = max(errs.get(key, 0.0), check_close(
                f"phase {phase} flash_fwd {case} {name} {list(shape)}",
                A.flash_fwd(*args)[0], A.flash_fwd_plain(*args)[0], dtype))
        qd = torch.randn(INF_SLOTS, heads, 64, device="cuda",
                         generator=gen).to(dtype)
        kp, vp = (torch.randn(pages, page, heads, 64, device="cuda",
                              generator=gen).to(dtype) for _ in range(2))
        tables = (torch.randperm(pages - 1, device="cuda", generator=gen)
                  + 1).reshape(INF_SLOTS, mb).to(torch.int32)
        positions = torch.tensor([0, 15, 16, 40, 129, 256, 400,
                                  P20_MAX_SEQ - 1][:INF_SLOTS],
                                 dtype=torch.int32, device="cuda")
        errs[f"paged_decode {name}"] = check_close(
            f"phase {phase} paged_decode {name} [{INF_SLOTS}, {heads}, 64] "
            f"over {mb} pages a slot",
            paged_flash_decode(qd, kp, vp, tables, positions),
            paged_flash_decode_plain(qd, kp, vp, tables, positions), dtype)
        for target, (din, dout) in (LORA_SHAPES.items() if sgmv else ()):
            x, a_pool, b_pool, ids = sgmv_case("cuda", gen, dtype, din, dout,
                                               INF_SLOTS)
            tag = f"phase 20 sgmv {target} {name} in {din} out {dout}"
            delta = lora_sgmv(x, a_pool, b_pool, ids)
            key = f"sgmv {name}"
            errs[key] = max(errs.get(key, 0.0), check_close(
                tag, delta, lora_sgmv_plain(x, a_pool, b_pool, ids), dtype,
                scaled=dtype != torch.float32),
                check_sgmv_add(tag, x, a_pool, b_pool, ids, delta))
    return errs


def phase_fleet(seed, card):
    """Phase 20. Returns ({kernel: {path: launches}}, stats)."""
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    t_phase = time.monotonic()
    root = Path("build") / "phase20"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cfg = GPT2Config.small()
    model = GPT2LMHeadModel(cfg, device="cuda", seed=seed)
    model.requires_grad_(False)
    vocab = cfg.vocab_size
    prompts = p20_prompts(seed, vocab)
    launches = {name: {} for name in launch_counters()}
    stats = {"card": card}

    def keep(path, got):
        for name, n in got.items():
            if n:
                launches[name][path] = n

    log(f"phase 20: the serving fleet, GPT-2 small ({cfg.n_layer} x "
        f"{cfg.n_embd}, vocab {cfg.vocab_padded}), {P20_REPLICAS} in-process "
        "replicas")
    router, stats["a_bf16"], got, _ = p20_fleet(model, "bf16", prompts,
                                                vocab, card)
    router.shutdown()
    keep("p20a_bf16", got)
    router, stats["a_fp32"], got, want = p20_fleet(model, "fp32", prompts,
                                                   vocab, card)
    keep("p20a_fp32", got)
    try:
        serial_ms, _ = p20_serial_ms(router, prompts[:P20_SERIAL])
        stats["f"], got = p20_door(router, prompts, want, card)
        keep("p20f_door", got)
        stats["b"], got = p20_restart(router, prompts, want, model,
                                      vocab, card)
        keep("p20b_restart", got)
    finally:
        router.shutdown()
    stats["c"], got = p20_brownout(model, vocab, seed, card)
    keep("p20c_brownout", got)
    stats["d"], got = p20_adapters(model, vocab, seed, card)
    keep("p20d_adapters", got)
    stats["e"], got = p20_worker(model, prompts, want, serial_ms, card,
                                 root)
    keep("p20e_worker", got)
    stats["kernels_vs_plain"] = p20_check_kernels(seed)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    stats["wall_s"] = time.monotonic() - t_phase
    log(f"phase 20: {stats['wall_s']:.1f} s ({card})")
    return launches, stats


# ---------------------------------------------------------------------------
# phase 21: the networked fleet and its control plane (serving/transport.py,
# node.py, journal.py, autoscaler.py, telemetry/hub.py)
# ---------------------------------------------------------------------------
P21_NODE = "n0"
P21_REPLICAS = ("r0", "r1")
P21_MAX_REPLICAS = 3   # r0, r1 and the autoscaler's spawn
P21_CHAOS = 8          # (b)'s requests, under conn.reset and frame.corrupt
P21_CRASH = 4          # (c)'s journalled requests
P21_STREAMED = 2       # tokens each (c) request streams before the crash
P21_RPC_TIMEOUT = 3.0  # (b)/(c): a frame the chaos eats costs this much
P21_AUTOSCALE = {"enabled": True, "min_replicas": 1, "max_replicas": 2,
                 "interval_secs": 0.1, "cooldown_secs": 1.0,
                 "hysteresis_secs": 2.0, "scale_up_utilization": 0.05,
                 "scale_down_utilization": 0.02, "drain_timeout_secs": 60.0}
P21_LAUNCH_MARK = "node: kernel launches "


class P21Node:
    """The node agent subprocess (``python -m
    deepspeed_tpu_torch.serving.node --spec-file ... --port 0``) hosting
    r0 and r1, its stderr in a file; ``fail`` prints the file's tail
    first."""

    def __init__(self, root, engine_spec):
        self.root = root
        self.log_path = root / "node.log"
        spec = {"node_id": P21_NODE,
                "replicas": {name: engine_spec for name in P21_REPLICAS},
                "max_replicas": P21_MAX_REPLICAS, "lease_secs": 30.0,
                "resume_grace_secs": 120.0}
        spec_path = root / "node_spec.json"
        spec_path.write_text(json.dumps(spec))
        self._log = open(self.log_path, "w")
        checkout = Path(__file__).resolve().parent
        t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "deepspeed_tpu_torch.serving.node",
             "--spec-file", str(spec_path), "--port", "0"],
            cwd=str(checkout), stdout=subprocess.PIPE, stderr=self._log,
            text=True)
        box = {}
        reader = threading.Thread(
            target=lambda: box.update(line=self.proc.stdout.readline()),
            daemon=True)
        reader.start()
        reader.join(300.0)
        line = box.get("line") or ""
        try:
            info = json.loads(line)
        except ValueError:
            info = {}
        if info.get("event") != "listening":
            self.fail(f"phase 21: the node agent announced {line!r} "
                      f"(exit code {self.proc.poll()})")
        self.start_s = time.monotonic() - t0
        self.address = (info["host"], int(info["port"]))
        self.announce = info

    @property
    def addr(self):
        return f"{self.address[0]}:{self.address[1]}"

    def nodes(self, replicas=P21_REPLICAS):
        return {P21_NODE: {"address": self.addr, "replicas": list(replicas)}}

    def text(self):
        self._log.flush()
        return self.log_path.read_text()

    def fail(self, msg):
        log(self.text()[-6000:])
        self.stop()
        fail(msg)

    def counts(self):
        """Each hosted replica's engine counts over the control session:
        cold prefills, decode steps, requests completed."""
        from deepspeed_tpu_torch.serving.transport import NodeControlClient
        from deepspeed_tpu_torch.telemetry.registry import wire_scalars

        reply = NodeControlClient(self.address).metrics_snapshot()
        out = {}
        for rep, entries in reply["replicas"].items():
            s = wire_scalars(entries)
            out[rep] = {"cold_prefills": int(s["infer/prefix_misses"]),
                        "decode_steps": int(s["infer/token_latency_ms/count"]),
                        "decode_ms_sum": s["infer/token_latency_ms/sum"],
                        "ttft_count": int(s["infer/ttft_ms/count"]),
                        "ttft_ms_sum": s["infer/ttft_ms/sum"],
                        "completed": int(s["infer/requests_completed"])}
        return out

    def memory(self):
        """The node process's card memory as ``nvidia-smi
        --query-compute-apps`` reports it (None where it lists no row for
        the node's pid, as in a container whose pids it cannot see), and
        the card's used memory from the driver (``cudaMemGetInfo``), MiB;
        this process allocates nothing while phase 21 measures, so a
        change of the latter is the node's."""
        rows = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True).stdout
        node = None
        for row in rows.strip().splitlines():
            pid, mib = (x.strip() for x in row.split(","))
            if pid.isdigit() and int(pid) == self.proc.pid:
                node = float(mib)
        free, total = torch.cuda.mem_get_info()
        return {"node_mib": node, "card_used_mib": (total - free) / 2 ** 20,
                "smi_rows": len(rows.strip().splitlines())}

    def stop(self):
        """SIGTERM (the node shuts down and logs its launches), then
        SIGKILL if it outlives 60 s."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(60.0)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._log.close()


def p21_completed(counts):
    return sum(c["completed"] for c in counts.values())


def p21_fleet(node, prompts, want, model, vocab, card):
    """(a) init_fleet's socket backend over the node's r0 and r1 with
    prefix affinity: 16 requests, each answered once with the single
    engine's tokens; then a request's round trip one at a time over the
    socket."""
    import deepspeed_tpu_torch

    from deepspeed_tpu_torch.serving.transport import SocketReplica

    tag = "phase 21(a) socket fleet"
    # each engine's first request pays its process's first launches (in
    # process, phase 20 paid them): one request a replica, not timed
    g = torch.Generator().manual_seed(P20_NEW)
    for name in P21_REPLICAS:
        replica = SocketReplica(f"warm:{name}", node.address,
                                remote_name=name).start()
        try:
            replica.submit(random_tokens(g, 40, vocab),
                           max_new_tokens=4).result(300.0)
        finally:
            replica.shutdown()
    counts0 = node.counts()
    before = p21_completed(counts0)
    router = deepspeed_tpu_torch.init_fleet(
        nodes=node.nodes(),
        config={"serving": {"backend": "socket",
                            "placement": "prefix_affinity",
                            "affinity_prefix_tokens": P20_AFFINITY}})
    try:
        t0 = time.monotonic()
        reqs = [router.submit(p, max_new_tokens=P20_NEW) for p in prompts]
        submit_s = time.monotonic() - t0
        got = [r.result(300.0) for r in reqs]
        wall = time.monotonic() - t0
        same_tokens(tag, prompts, got, want, model, vocab)
        snap = p20_clean(tag, router, reqs)
        serial_ms, serial = p20_serial_ms(router, prompts[:P20_SERIAL])
        if [r.tokens for r in serial] != want[:P20_SERIAL]:
            node.fail(f"{tag}: the one-at-a-time requests' tokens differ")
    finally:
        router.shutdown()
    counts1 = node.counts()
    done = p21_completed(counts1) - before

    def delta(key):
        return sum(counts1[r][key] - counts0[r][key] for r in counts1)

    # the engines' own view inside the node: their mean TTFT and decode
    # step over (a), the one-at-a-time requests included
    engine_ttft_ms = delta("ttft_ms_sum") / max(delta("ttft_count"), 1)
    engine_step_ms = delta("decode_ms_sum") / max(delta("decode_steps"), 1)
    if snap["fleet/requests_completed"] != len(prompts) or done != len(
            prompts) + P20_SERIAL:
        node.fail(f"{tag}: the fleet completed "
                  f"{snap['fleet/requests_completed']} and the node {done} "
                  f"requests for {len(prompts)} + {P20_SERIAL} sent")
    served = sorted({r.replica_id for r in reqs})
    stats = {"card": card, "requests": len(reqs), "replicas_serving": served,
             "ttft_p50_ms": snap["fleet/ttft_p50_ms"],
             "ttft_p99_ms": snap["fleet/ttft_p99_ms"],
             "affinity_hits": snap["fleet/affinity_hits"],
             "tokens_per_s": len(prompts) * P20_NEW / wall, "wall_s": wall,
             "submit_s": submit_s, "ms_a_request": serial_ms,
             "engine_ttft_ms_mean": engine_ttft_ms,
             "engine_decode_step_ms_mean": engine_step_ms}
    log(f"  {tag}: {len(reqs)} requests on {served}, each answered once "
        f"with the single engine's float32 tokens; TTFT p50 "
        f"{stats['ttft_p50_ms']:.3f} ms p99 {stats['ttft_p99_ms']:.3f} ms, "
        f"{stats['tokens_per_s']:.1f} tokens/s over the fleet's wall (the "
        f"{len(prompts)} submits took {submit_s:.3f} s), {serial_ms:.3f} ms "
        f"a request one at a time over the socket; inside the node the "
        f"engines' mean TTFT {engine_ttft_ms:.3f} ms and decode step "
        f"{engine_step_ms:.3f} ms ({card})")
    return stats


def p21_chaos(node, prompts, want, model, vocab, card):
    """(b) conn.reset once and frame.corrupt once on the router's sends
    while 8 requests stream: each answered once with (a)'s tokens, and
    the node ran each exactly once."""
    import deepspeed_tpu_torch

    tag = "phase 21(b) conn.reset + frame.corrupt"
    prompts, want = prompts[:P21_CHAOS], want[:P21_CHAOS]
    before = p21_completed(node.counts())
    router = deepspeed_tpu_torch.init_fleet(
        nodes=node.nodes(),
        config={"serving": {"backend": "socket",
                            "placement": "prefix_affinity",
                            "affinity_prefix_tokens": P20_AFFINITY,
                            "rpc_timeout_secs": P21_RPC_TIMEOUT},
                "resilience": {"fault_injection": {
                    "enabled": True, "seed": 0, "faults": [
                        {"site": "conn.reset", "after": 4, "times": 1},
                        {"site": "frame.corrupt", "after": 7,
                         "times": 1}]}}})
    try:
        reqs = [router.submit(p, max_new_tokens=P20_NEW) for p in prompts]
        got = [r.result(300.0) for r in reqs]
        injected = dict(router._faults.injected)
        router.refresh_telemetry()
        snap = router.metrics.snapshot()
    finally:
        router.shutdown()
    same_tokens(tag, prompts, got, want, model, vocab)
    done = p21_completed(node.counts()) - before
    bad = [r.request_id for r in reqs if r.finish_reason != "max_new_tokens"]
    if injected != {"conn.reset": 1, "frame.corrupt": 1}:
        node.fail(f"{tag}: injected {injected}")
    if bad or done != len(prompts) or snap[
            "fleet/requests_completed"] != len(prompts):
        node.fail(f"{tag}: requests {bad} unfinished; the node completed "
                  f"{done}, the fleet {snap['fleet/requests_completed']}, "
                  f"of {len(prompts)}")
    net = {k: v for k, v in snap.items() if k.startswith("fleet/net_")}
    stats = {"card": card, "injected": injected, "net": net,
             "rerouted": snap["fleet/requests_rerouted"],
             "node_completed": done}
    log(f"  {tag}: {len(prompts)} requests, zero lost, zero doubled (the "
        f"node completed {done}), tokens equal (a)'s; injected {injected}, "
        f"{net}, rerouted {stats['rerouted']}")
    return stats


def phase21_router(spec_path):
    """(c)'s first router, in a process of its own: init_fleet over the
    node with the journal armed, P21_CRASH requests with idempotency keys;
    once each has streamed P21_STREAMED tokens the router.crash site is
    armed for the next monitor tick, which SIGKILLs this process. Prints
    one JSON line a finished request and one at submission."""
    import deepspeed_tpu_torch

    spec = json.loads(Path(spec_path).read_text())
    router = deepspeed_tpu_torch.init_fleet(
        nodes=spec["nodes"],
        config={"serving": {"backend": "socket",
                            "placement": "prefix_affinity",
                            "affinity_prefix_tokens": P20_AFFINITY,
                            "rpc_timeout_secs": P21_RPC_TIMEOUT,
                            "journal": {"enabled": True,
                                        "dir": spec["journal"]}},
                "resilience": {"fault_injection": {
                    "enabled": True, "faults": [
                        {"site": "router.crash", "after": 10 ** 9,
                         "times": 1}]}}})
    lock = threading.Lock()

    def say(obj):
        # one whole line at a time: the reporting threads share stdout
        with lock:
            sys.stdout.write(json.dumps(obj) + "\n")
            sys.stdout.flush()

    reqs = [router.submit(p, max_new_tokens=P20_NEW,
                          idempotency_key=f"p21c-{i}")
            for i, p in enumerate(spec["prompts"])]
    say({"event": "submitted", "epoch": router._journal.incarnation})

    def report(i, r):
        r._done.wait()
        say({"event": "answered", "key": f"p21c-{i}", "tokens": r.tokens,
             "reason": r.finish_reason})

    for i, r in enumerate(reqs):
        threading.Thread(target=report, args=(i, r), daemon=True).start()

    def streamed(r):
        entry = router._outstanding.get(r.request_id)
        return r.done or (entry is not None
                          and len(entry[1].tokens) >= P21_STREAMED)

    deadline = time.monotonic() + 120.0
    while not all(streamed(r) for r in reqs):
        if time.monotonic() > deadline:
            say({"event": "no stream"})
            sys.exit(1)
        time.sleep(0.002)
    faults = router._faults
    with faults._lock:
        for f in faults._specs:
            f.after = faults._passes.get("router.crash", 0)
    say({"event": "armed"})
    time.sleep(120.0)
    sys.exit(1)  # the crash site never fired


def p21_crash(node, prompts, want, model, vocab, card, root):
    """(c) serving.journal, router.crash mid-stream in a router process,
    and a second init_fleet on the same journal: epoch + 1, r0 and r1
    adopted with no engine built, the old epoch's late op fenced out, the
    journalled requests finished with (a)'s tokens (those answered before
    the crash too), and each run once on the node."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.serving.replica import FencedOut
    from deepspeed_tpu_torch.serving.transport import NodeControlClient

    tag = "phase 21(c) router.crash + journal recovery"
    prompts, want = prompts[:P21_CRASH], want[:P21_CRASH]
    journal = root / "journal"
    spec = root / "router_spec.json"
    spec.write_text(json.dumps({"nodes": node.nodes(), "prompts": prompts,
                                "journal": str(journal)}))
    before = p21_completed(node.counts())
    builds = node.text().count("init_inference:")
    checkout = Path(__file__).resolve().parent
    t0 = time.monotonic()
    with open(root / "router.log", "w") as err:
        child = subprocess.run(
            [sys.executable, str(checkout / "chip_smoke.py"),
             "--phase21-router", str(spec)],
            cwd=str(checkout), stdout=subprocess.PIPE, stderr=err,
            text=True, timeout=300)
    child_s = time.monotonic() - t0
    events = [json.loads(ln) for ln in child.stdout.splitlines()
              if ln.startswith("{")]
    kinds = [e["event"] for e in events]
    if child.returncode != -signal.SIGKILL or "armed" not in kinds:
        log((root / "router.log").read_text()[-4000:])
        node.fail(f"{tag}: the router process exited {child.returncode} "
                  f"after {kinds}, not by the router.crash site")
    old_epoch = events[0]["epoch"]
    answered = {e["key"]: e for e in events if e["event"] == "answered"}
    t0 = time.monotonic()
    router = deepspeed_tpu_torch.init_fleet(
        nodes=node.nodes(),
        config={"serving": {"backend": "socket",
                            "placement": "prefix_affinity",
                            "affinity_prefix_tokens": P20_AFFINITY,
                            "rpc_timeout_secs": P21_RPC_TIMEOUT,
                            "journal": {"enabled": True,
                                        "dir": str(journal)}}})
    recover_s = time.monotonic() - t0
    try:
        epoch = router._journal.incarnation
        adopted = router.metrics.gauge("fleet/adopted_replicas").value
        finished, results = [], {}
        for i, p in enumerate(prompts):
            key = f"p21c-{i}"
            fr = router.find_inflight(key)
            if fr is not None:
                results[key] = fr.result(300.0)
                finished.append(key)
            elif key in answered and answered[key]["reason"] == \
                    "max_new_tokens":
                results[key] = answered[key]["tokens"]
            else:
                node.fail(f"{tag}: {key} was neither journalled nor "
                          "answered before the crash")
        try:
            NodeControlClient(node.address, epoch=old_epoch).node_info()
            fenced = None
        except FencedOut as e:
            fenced = (e.epoch, e.high_water)
        roster = NodeControlClient(node.address).node_info()["replicas"]
    finally:
        router.shutdown()
    got = [results[f"p21c-{i}"] for i in range(len(prompts))]
    same_tokens(tag, prompts, got, want, model, vocab)
    done = p21_completed(node.counts()) - before
    if epoch != old_epoch + 1 or adopted != len(P21_REPLICAS):
        node.fail(f"{tag}: recovered at epoch {epoch} (the crashed router "
                  f"{old_epoch}) adopting {adopted} replicas")
    if fenced != (old_epoch, epoch):
        node.fail(f"{tag}: the old router's late op gave {fenced}")
    if roster != list(P21_REPLICAS) or node.text().count(
            "init_inference:") != builds:
        node.fail(f"{tag}: the node's roster {roster}; engines built since "
                  "the crash")
    if not finished or done != len(prompts):
        node.fail(f"{tag}: {len(finished)} requests finished after the "
                  f"crash; the node completed {done} of {len(prompts)}")
    stats = {"card": card, "epoch": [old_epoch, epoch], "adopted": adopted,
             "finished_after_crash": len(finished),
             "answered_before_crash": len(prompts) - len(finished),
             "fenced": fenced, "router_process_s": child_s,
             "recover_s": recover_s}
    log(f"  {tag}: the router process died by the site after {kinds}; the "
        f"second init_fleet came up at epoch {epoch} in {recover_s:.3f} s "
        f"adopting {adopted} replicas (no engine built), fenced the old "
        f"epoch {fenced}, finished {len(finished)} journalled requests "
        f"({stats['answered_before_crash']} answered before the crash); "
        f"the node ran each once; tokens equal (a)'s")
    return stats


def p21_autoscale(node, prompts, want, model, vocab, card):
    """(d) serving.autoscale (min 1, max 2, the socket provider) from one
    replica: a burst scales up, spawn_replica builds a GPT-2 engine inside
    the node on the card; idle past the cooldown retires it. The node
    process's card memory before, after the spawn and after the retire."""
    import deepspeed_tpu_torch

    tag = "phase 21(d) autoscale"
    builds = node.text().count("dtype fp32 on cuda")
    mem = {"before": node.memory()}
    router = deepspeed_tpu_torch.init_fleet(
        nodes=node.nodes(("r0",)),
        config={"serving": {"backend": "socket",
                            "autoscale": P21_AUTOSCALE}})
    scaler = router._autoscaler
    try:
        t0 = time.monotonic()
        reqs = [router.submit(p, max_new_tokens=P20_NEW) for p in prompts]
        t_decide = None
        while len(router.live_replica_ids()) < 2:
            if t_decide is None and scaler.state.op_in_flight:
                t_decide = time.monotonic()
            if time.monotonic() - t0 > 300.0:
                node.fail(f"{tag}: the burst never scaled the fleet up")
            time.sleep(0.005)
        t_join = time.monotonic()
        spawned = sorted(set(router.live_replica_ids()) - {f"{P21_NODE}:r0"})
        got = [r.result(300.0) for r in reqs]
        mem["spawned"] = node.memory()
        # the spawned engine's counts, read before the idle window
        # (hysteresis_secs) ends and the retire takes them away
        spawn_counts = node.counts()
        roster_up = sorted(spawn_counts)
        while len(router.live_replica_ids()) > 1:
            if time.monotonic() - t_join > 300.0:
                node.fail(f"{tag}: idle never scaled the fleet down")
            time.sleep(0.02)
        t_down = time.monotonic()
        deadline = time.monotonic() + 60.0
        while sorted(node.counts()) != list(P21_REPLICAS):
            if time.monotonic() > deadline:
                node.fail(f"{tag}: the node still hosts "
                          f"{sorted(node.counts())}")
            time.sleep(0.05)
        # the counter moves once the provider's retire returns
        downs = router.metrics.counter("fleet/autoscale_downs")
        while downs.value < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        snap = router.metrics.snapshot()
    finally:
        router.shutdown()
    mem["retired"] = node.memory()
    same_tokens(tag, prompts, got, want, model, vocab)
    if roster_up != sorted([*P21_REPLICAS, spawned[0].split(":")[1]]) or (
            node.text().count("dtype fp32 on cuda") != builds + 1):
        node.fail(f"{tag}: the node's roster {roster_up} after the spawn "
                  f"of {spawned}")
    if snap["fleet/autoscale_ups"] < 1 or snap["fleet/autoscale_downs"] < 1:
        node.fail(f"{tag}: ups {snap['fleet/autoscale_ups']}, downs "
                  f"{snap['fleet/autoscale_downs']}")
    key = "node_mib" if all(m["node_mib"] is not None
                            for m in mem.values()) else "card_used_mib"
    engine_mib = mem["spawned"][key] - mem["before"][key]
    held_mib = mem["retired"][key] - mem["before"][key]
    if engine_mib <= 0 or held_mib >= engine_mib:
        node.fail(f"{tag}: card memory {mem} MiB: the retire freed nothing")
    spawned_name = spawned[0].split(":")[1]
    # the node's own allocator after its start, the spawn and the retire
    # (its log): the retire must free the spawned engine, not leave one
    # engine's weights held
    held = {}
    for line in node.text().splitlines():
        for what, mark in (("start", "replica(s) on"),
                           ("spawned", "spawned replica"),
                           ("retired", "retired replica")):
            if mark in line and "GB allocated" in line:
                log(f"  node: {line.split('] ')[-1]}")
                held[what] = float(line.split("; ")[-1].split(" GB")[0])
    weights_gb = sum(p.numel() * p.element_size()
                     for p in model.parameters()) / 1e9
    if len(held) != 3 or held["retired"] - held["start"] >= weights_gb:
        node.fail(f"{tag}: the node's allocated GB {held}: the retire left "
                  f"one engine's weights ({weights_gb:.3f} GB) held")
    stats = {"card": card, "spawned": spawned,
             "decide_s": None if t_decide is None else t_decide - t0,
             "spawn_s": t_join - (t_decide or t0), "burst_to_join_s":
             t_join - t0, "join_to_retire_s": t_down - t_join,
             "memory_mib": mem, "memory_read": key, "engine_mib": engine_mib,
             "node_allocated_gb": held, "weights_gb": weights_gb,
             "held_after_retire_mib": held_mib,
             "ups": snap["fleet/autoscale_ups"],
             "downs": snap["fleet/autoscale_downs"],
             "spawned_counts": spawn_counts[spawned_name]}
    log(f"  {tag}: the burst of {len(prompts)} requests scaled up to "
        f"{spawned} (decided at {stats['decide_s']} s, joined "
        f"{stats['spawn_s']:.3f} s later, the engine built inside the node "
        f"on the card), idle retired it {stats['join_to_retire_s']:.3f} s "
        f"after the join; the node's allocated GB {held} (an engine's "
        f"weights {weights_gb:.3f}); the card's memory {mem} MiB (by {key}:"
        f" the spawn {engine_mib:.0f}, held after the retire "
        f"{held_mib:.0f}); tokens equal (a)'s ({card})")
    return stats


def p21_hub(node, prompt, card):
    """(e) serving.hub armed: the door's /metrics and /statz answer 200
    and carry the node's replica series."""
    import http.client

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.serving import serve_http

    tag = "phase 21(e) hub"
    router = deepspeed_tpu_torch.init_fleet(
        nodes=node.nodes(),
        config={"serving": {"backend": "socket",
                            "hub": {"enabled": True,
                                    "interval_secs": 0.25}}})
    door = serve_http(router, host="127.0.0.1", port=0)
    out = {}
    try:
        router.submit(prompt, max_new_tokens=4).result(300.0)
        router.hub.scrape_once()
        host, port = door.address
        for path in ("/metrics", "/statz"):
            conn = http.client.HTTPConnection(host, port, timeout=60.0)
            conn.request("GET", path)
            resp = conn.getresponse()
            out[path] = (resp.status, resp.read().decode())
            conn.close()
    finally:
        door.shutdown()
        router.shutdown()
    metrics, statz = out["/metrics"], out["/statz"]
    series = [ln for ln in metrics[1].splitlines()
              if ln.startswith("infer_requests_completed{")]
    want = {f'node="{P21_NODE}",replica="{r}"' for r in P21_REPLICAS}
    replicas = sorted(json.loads(statz[1])["replicas"]) if statz[0] == 200 \
        else []
    if metrics[0] != 200 or not all(any(w in s for s in series)
                                    for w in want):
        node.fail(f"{tag}: /metrics {metrics[0]}, series {series}")
    if statz[0] != 200 or replicas != [f"{P21_NODE}/{r}"
                                       for r in P21_REPLICAS]:
        node.fail(f"{tag}: /statz {statz[0]}, replicas {replicas}")
    log(f"  {tag}: /metrics 200 with {series}; /statz 200 with replicas "
        f"{replicas}")
    return {"card": card, "series": series, "statz_replicas": replicas}


def p21_leftover_nodes():
    """Pids of node agent processes still running on this machine."""
    out = []
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            cmd = (entry / "cmdline").read_bytes()
        except OSError:
            continue
        if b"deepspeed_tpu_torch.serving.node" in cmd:
            out.append(int(entry.name))
    return out


def phase_fleet_net(seed, card):
    """Phase 21. Returns ({kernel: {path: launches}}, stats)."""
    import deepspeed_tpu_torch  # noqa: F401
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    t_phase = time.monotonic()
    # absolute: the node and router processes run from the checkout
    root = (Path("build") / "phase21").resolve()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cfg = GPT2Config.small()
    model = GPT2LMHeadModel(cfg, device="cuda", seed=seed)
    model.requires_grad_(False)
    vocab = cfg.vocab_size
    prompts = p20_prompts(seed, vocab)
    log(f"phase 21: the networked fleet, GPT-2 small ({cfg.n_layer} x "
        f"{cfg.n_embd}, vocab {cfg.vocab_padded}), float32, one node agent "
        f"process hosting {list(P21_REPLICAS)}")
    single = p20_factory(model, "fp32")()
    try:
        want = single.generate(prompts, max_new_tokens=P20_NEW)
    finally:
        single.close()
        del single
    t0 = time.monotonic()
    p20_checkpoint(model, root / "ckpt")
    save_s = time.monotonic() - t0
    engine_spec = {"model": {}, "config": {"inference": dict(
        p20_block("fp32"), checkpoint={"load_dir": str(root / "ckpt")})}}
    node = P21Node(root, engine_spec)
    stats = {"card": card, "checkpoint_save_s": save_s,
             "node_start_s": node.start_s}
    log(f"  the node agent announced {node.announce} after "
        f"{node.start_s:.2f} s (its engines built from the checkpoint, "
        f"saved in {save_s:.2f} s)")
    try:
        stats["a"] = p21_fleet(node, prompts, want, model, vocab, card)
        stats["b"] = p21_chaos(node, prompts, want, model, vocab, card)
        stats["c"] = p21_crash(node, prompts, want, model, vocab, card, root)
        stats["d"] = p21_autoscale(node, prompts, want, model, vocab, card)
        stats["e"] = p21_hub(node, prompts[0], card)
        final = node.counts()
    except BaseException:
        if node.proc.poll() is None:
            log(node.text()[-6000:])
        node.stop()
        raise
    node.stop()
    text = node.log_path.read_text()
    lines = [ln for ln in text.splitlines() if ln.startswith(P21_LAUNCH_MARK)]
    if len(lines) != 1:
        log(text[-6000:])
        fail(f"phase 21: the node logged {len(lines)} launch lines (exit "
             f"code {node.proc.returncode})")
    launches = json.loads(lines[0][len(P21_LAUNCH_MARK):])
    spawned = stats["d"]["spawned_counts"]
    st = {k: sum(c[k] for c in final.values()) + spawned[k]
          for k in ("cold_prefills", "decode_steps")}
    p20_check_launches("phase 21 node", launches, st)
    left = p21_leftover_nodes()
    if node.proc.returncode is None or left:
        fail(f"phase 21: node agent processes left: {left}")
    stats["launches"] = launches
    stats["engine_counts"] = st
    stats["kernels_vs_plain"] = p20_check_kernels(seed, phase=21,
                                                  sgmv=False)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    stats["wall_s"] = time.monotonic() - t_phase
    log(f"phase 21: the node's launches over its life {launches} = 12 x "
        f"its engines' {st}; no node process left; {stats['wall_s']:.1f} s "
        f"({card})")
    out = {name: {} for name in launch_counters()}
    for name, n in launches.items():
        if n:
            out[name]["p21"] = n
    return out, stats


# ---------------------------------------------------------------------------
# phase 22: int8 moments across stages, experts and a model axis with
# offload (A7f 1-2), uneven pipeline microbatches (A7f 3), serving over a
# data axis (A8c)
# ---------------------------------------------------------------------------
P22_WORLD = 2
P22_INT8 = {"data_types": {"optimizer_state_dtype": "int8"}}
P22_OFFLOAD = {"zero_optimization": {"stage": 0, "offload_optimizer": {
    "device": "cpu"}}}
# (a) the int8 runs of the two ranks on phase 18's batch and windows:
# (name, model kind, mesh block, the kind of one rank's reference, ZeRO
# stage)
P22_INT8_RUNS = (
    ("pp2_int8", "pp", {"pipeline_parallel_size": P22_WORLD}, "dense", 1),
    ("ep2_int8", "moe", {"data_parallel_size": P22_WORLD}, "moe", 0),
    ("ep2_int8_z3", "moe", {"data_parallel_size": P22_WORLD}, "moe", 3),
)
# (b) a model rank's attention q shape: 6 of 12 heads on phase 16's rows
P22_MP_SHAPE = (P16_MICRO, 12 // P22_WORLD, 1024, 64)
# (c) the uneven split: pp 2 x dp 4 (8 ranks), 12 global rows a micro-step
# in 2 microbatches of 6, so each data rank runs a 3-row piece of one;
# GPT-2 small at full width cut to 2 blocks (one a stage), one window
P22_PP, P22_DP = 2, 4
P22_ROWS, P22_MICROBATCHES, P22_LAYERS = 12, 2, 2
P22_UNEVEN_SHAPE = (P22_ROWS // P22_DP, 12, 1024, 64)
# (c)'s second run: int8 moments at ZeRO stage 3
P22_INT8_Z3 = dict(P22_INT8, zero_optimization={"stage": 3})
# (a), (b): how far a rank's int8 first moment after the first window
# (joined into the whole JAX leaves) may sit from one rank's: scales
# relative, and the share of codes one step apart. The float32 gradients
# of the two layouts differ by ~2e-5 of their norm on an H100 (summation
# order), so a code on a rounding edge may flip; from the second step a
# flipped code feeds the next moment, and scales then part by up to
# 4.7e-3 and codes by 2 steps (measured on an H100 80GB HBM3 at 700 W),
# so the state is read after one step. A layout fault moves whole
# blocks, by far more.
P22_SCALE_RTOL = 1e-3
P22_CODE_FLIPS = 1e-3
# (d) serving at dp 2: 2 templates of 3 and 2 pages, 3 tails each, then 2
# prompts of their own; the rank-16 adapter on every third request
P22_TEMPLATES = (48, 32)
P22_NEW = 24
P22_ADAPTER = "a"


def p22_prompts(seed, vocab):
    """(d)'s 8 prompts and the adapter of each: the two templates' first
    tails lead, then their other tails, then 2 prompts of their own."""
    g = torch.Generator().manual_seed(seed + 220)
    heads = [random_tokens(g, n, vocab) for n in P22_TEMPLATES]
    prompts = [h + random_tokens(g, k, vocab) for k in (5, 11, 17)
               for h in heads]
    prompts += [random_tokens(g, n, vocab) for n in (40, 77)]
    names = [P22_ADAPTER if i % 3 == 0 else None
             for i in range(len(prompts))]
    return prompts, names


def p22_serve(seed, world):
    """(d) One float32 serving run, paged KV with fused decode and the
    prefix cache, the adapters block with one rank-16 adapter: every rank
    builds the engine (over a data axis of ``world``, or one process);
    the leader loads the adapter, admits the templates' first requests,
    one scheduler step later the other six (which hit their pages), and
    serves them; a follower follows. Returns the leader's tokens and
    counts, this rank's launches and coordinates, and the bytes the
    engine holds on it."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    model = GPT2LMHeadModel(GPT2Config.small(dropout=0.0), device="cuda",
                            seed=seed)
    base = {n: t.detach().cpu() for n, t in model.state_dict().items()}
    adapter = synthetic_adapter(base, seed + 22)
    prompts, names = p22_prompts(seed, model.config.vocab_size)
    config = {"inference": p20_block("fp32"),
              "adapters": {"enabled": True, "rank": LORA_RANK,
                           "pool_slots": LORA_POOL_SLOTS}}
    if world > 1:
        config["mesh"] = {"data_parallel_size": world}
    engine = deepspeed_tpu_torch.init_inference(model=model, config=config)
    del model, base
    gc.collect()
    torch.cuda.empty_cache()

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    mesh = engine.mesh
    out = {"weights_gb": nbytes(engine.model.parameters()) / 1e9,
           "kv_pool_gb": nbytes((engine._cache.k, engine._cache.v)) / 1e9,
           "adapter_pool_gb": nbytes(
               [t for ab in engine._adapter_pool.values() for t in ab]) / 1e9,
           "kv_pool_shape": list(engine._cache.k.shape),
           "held_gb": torch.cuda.memory_allocated() / 1e9,
           "coords": ([engine.rank, mesh.data_rank, mesh.model_rank]
                      if mesh is not None else [0, 0, 0]),
           "leader": engine.is_leader}
    zero_launches()
    if engine.is_leader:
        engine.load_adapter(P22_ADAPTER, adapter_state=adapter)
        t0 = time.monotonic()
        reqs = [engine.submit(p, max_new_tokens=P22_NEW, adapter=n)
                for p, n in zip(prompts[:2], names[:2])]
        engine.scheduler.step()
        reqs += [engine.submit(p, max_new_tokens=P22_NEW, adapter=n)
                 for p, n in zip(prompts[2:], names[2:])]
        engine.scheduler.run_until_idle()
        torch.cuda.synchronize()
        out.update(tokens=[r.result() for r in reqs],
                   stats=engine_stats(engine, time.monotonic() - t0))
        engine.close()
    else:
        engine.serve_forever()
    torch.cuda.synchronize()
    out["launches"] = read_launches()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def p22_offload_engine(seed, mp):
    """(b) initialize() on GPT-2 small at full width and depth at a model
    axis of ``mp`` (the model's partition_specs) with int8 moments and the
    optimizer offloaded to the host (ZeRO stage 0): float32 Adam at
    dropout 0 on phase 16's batches and windows."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    gc.collect()
    torch.cuda.empty_cache()
    model = GPT2LMHeadModel(GPT2Config.small(dropout=0.0), device="cuda",
                            seed=seed)
    cfg = p14_config("Adam", "fp32", 0, P16_MICRO, 1, dict(
        P22_INT8, **P22_OFFLOAD, mesh={"model_parallel_size": mp}))
    cfg.update(train_batch_size=P16_MICRO * P16_ACCUM,
               gradient_accumulation_steps=P16_ACCUM)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config_params=cfg,
        param_specs=(deepspeed_tpu_torch.partition_specs(model) if mp > 1
                     else None))
    return engine


def p22_int8_leaves(engine):
    """The engine's int8 first moment on the host as the whole JAX leaves:
    a group whose leaf spans ranks joined over the world (a collective of
    every rank), the others as this rank holds them."""
    from deepspeed_tpu_torch.runtime import checkpointing

    # copies: on the host (offload) .cpu() would alias the live state
    mu = {g: {k: t.detach().cpu().clone() for k, t in leaf.items()}
          for g, leaf in engine.optimizer_state["mu"].items()}
    return checkpointing.whole_int8_moments(engine, mu)


def p22_save_int8(path):
    """An ``after_first`` hook for a rank's run: its whole int8 leaves
    (through the checkpoint's join, runtime/checkpointing.py), written to
    ``path`` by rank 0."""
    import torch.distributed as dist

    def save(engine):
        leaves = p22_int8_leaves(engine)
        if dist.get_rank() == 0:
            torch.save(leaves, path)

    return save


def p22_compare_int8(tag, got, want):
    """Each group of ``got`` (rank 0's whole int8 leaves) against one
    rank's ``want``: the blocks past the shorter leaf zero, the scales
    within P22_SCALE_RTOL, the codes at most one step apart on at most
    P22_CODE_FLIPS of them. Returns the measured gaps."""
    from deepspeed_tpu_torch.ops.quant import BLOCK

    worst, flips, steps, total, where = 0.0, 0, 0, 0, None
    for g, leaf in got.items():
        ref = want[g]
        nb = min(leaf["scale"].numel(), ref["scale"].numel())
        for t, n in ((leaf["q"], nb * BLOCK), (ref["q"], nb * BLOCK),
                     (leaf["scale"], nb), (ref["scale"], nb)):
            if t[n:].any():
                fail(f"phase 22 {tag} {g}: nonzero past the shared blocks")
        a, b = leaf["scale"][:nb].double(), ref["scale"][:nb].double()
        rel = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
        if rel >= worst:
            worst, where = rel, g
        step = (leaf["q"][:nb * BLOCK].int() - ref["q"][:nb * BLOCK].int()
                ).abs()
        flips += int((step > 0).sum())
        steps = max(steps, int(step.max()))
        total += step.numel()
    out = {"groups": len(got), "scale_rel_max": worst, "worst_group": where,
           "code_flips": flips, "codes": total, "max_step": steps}
    log(f"  {tag}: int8 first moment after one window vs one rank's over "
        f"{len(got)} groups: scales max rel {worst:.3e} ({where}; tol "
        f"{P22_SCALE_RTOL:g}), {flips} of {total} codes apart, at most "
        f"{steps} step")
    if worst > P22_SCALE_RTOL or steps > 1 or flips > P22_CODE_FLIPS * total:
        fail(f"phase 22 {tag}: the int8 state is not one rank's ({out})")
    return out


def p22_host_gb(engine):
    """The host bytes (GB) of the optimizer's masters and moments."""
    def walk(x):
        if torch.is_tensor(x):
            return (x.numel() * x.element_size()
                    if x.device.type == "cpu" else 0)
        if isinstance(x, dict):
            return sum(walk(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return sum(walk(v) for v in x)
        return 0

    return (walk(engine.params) + walk(engine.optimizer_state)) / 1e9


class P22Held:
    """The card bytes (GB) a rank's engine holds: ``arm(engine)`` before a
    window records the gradient buffer at its update, ``read(engine)``
    adds the parameters (the module's, and the masters that are not its
    tensors or views of them) and the optimizer state's tensors (int8
    codes and scales, bf16 or float32 moments)."""

    def __init__(self):
        self.grads_gb = None

    @staticmethod
    def _gb(ts):
        return sum(t.numel() * t.element_size() for t in ts
                   if t.device.type == "cuda") / 1e9

    def arm(self, engine):
        update = engine._update

        def once():
            self.grads_gb = self._gb(engine._grad_buffer.values())
            del engine._update
            return update()

        engine._update = once

    def read(self, engine):
        module = [p.data for p in engine.module.parameters()]
        storages = {p.untyped_storage().data_ptr() for p in module}
        masters = [t for t in engine.params.values()
                   if t.untyped_storage().data_ptr() not in storages]

        def tensors(x):
            if torch.is_tensor(x):
                yield x
            elif isinstance(x, dict):
                for v in x.values():
                    yield from tensors(v)

        return {"zero_stage": engine.zero_stage,
                "params_gb": self._gb(module) + self._gb(masters),
                "grads_gb": self.grads_gb,
                "moments_gb": self._gb(tensors(engine.optimizer_state))}


def p22_held_line(tag, got, ref):
    """A log line of the bytes ``got`` holds beside ``ref``'s (stage 0)."""
    return (f"  {tag}: ZeRO stage {got['zero_stage']} holds parameters "
            f"{got['params_gb']:.4f} GB, gradients {got['grads_gb']:.4f} GB"
            f", moments {got['moments_gb']:.4f} GB; stage "
            f"{ref['zero_stage']} {ref['params_gb']:.4f}, "
            f"{ref['grads_gb']:.4f}, {ref['moments_gb']:.4f} GB")


def p22_check_held(tag, got, ref):
    """Fail unless ``got`` (ZeRO stage 3) holds fewer parameter, gradient
    and moment bytes than ``ref`` (stage 0): at stage 3 the parameters are
    the persistent shards, with no masters beside them."""
    for key in ("params_gb", "grads_gb", "moments_gb"):
        if not got[key] < ref[key]:
            fail(f"phase 22 {tag}: {key} {got[key]:.4f} at ZeRO stage "
                 f"{got['zero_stage']}, not under stage {ref['zero_stage']}'s"
                 f" {ref[key]:.4f}")


def p22_uneven_engine(seed, pp, dp, extra=None):
    """(c) initialize() on GPT-2 small at full width and P22_LAYERS blocks:
    at ``pp`` above 1 the pipelined model (P22_MICROBATCHES microbatches
    of the global batch) over a pipe axis of ``pp`` and a data axis of
    ``dp``; float32 Adam at dropout 0, ZeRO stage 0 (``extra``: more
    engine config), one micro-step of P22_ROWS global rows a window."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    fields = (dict(pipeline_stages=pp, pipeline_microbatches=P22_MICROBATCHES)
              if pp > 1 else {})
    model = GPT2LMHeadModel(GPT2Config.small(dropout=0.0, n_layer=P22_LAYERS,
                                             **fields),
                            device="cuda", seed=seed)
    cfg = p14_config("Adam", "fp32", 0, P22_ROWS // dp, dp, dict(
        extra or {}, **({"mesh": {"pipeline_parallel_size": pp}} if pp > 1
                        else {})))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model,
                                                config_params=cfg)
    return engine


def p22_uneven_window(engine, seed):
    """One window on this data rank's rows of the global batch: its loss,
    launches, the pipeline plan it ran, the memory held and the peak."""
    from deepspeed_tpu_torch import GPT2Config

    g = torch.Generator().manual_seed(seed + 2203)
    rows = torch.randint(0, GPT2Config.small().vocab_size, (P22_ROWS, 1024),
                         generator=g).cuda()
    k = P22_ROWS // engine.dp_world_size
    rows = rows[engine.data_rank * k:(engine.data_rank + 1) * k]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.monotonic()
    loss = float(engine.train_batch(iter([(rows, rows)])))
    torch.cuda.synchronize()
    plan = getattr(engine.module, "last_pipeline_plan", None)
    return {"losses": [loss], "launches": read_launches(),
            "window_s": time.monotonic() - t0, "held_gb": held / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "skipped": engine.skipped_steps,
            "coords": [engine.pipe_rank, engine.data_rank],
            "plan": None if plan is None else json.loads(json.dumps(plan))}


def phase22_rank(spec_path):
    """One of phase 22's two ranks (a subprocess) of the gloo group the
    phase makes: (a) int8 moments at a pipe axis of 2 and with the MoE
    experts over a data axis of 2 (float32 Adam, phase 18's batch); (b)
    int8 moments at a model axis of 2 with the optimizer offloaded; (d)
    serving at a data axis of 2. Writes its results as JSON."""
    import torch.distributed as dist

    spec = json.loads(Path(spec_path).read_text())
    rank, seed = spec["rank"], spec["seed"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{spec['port']}", rank=rank,
        world_size=P22_WORLD)
    shapes = p17_record_shapes()
    root = Path(spec["out"]).parent
    out = {}
    for name, kind, mesh, _, stage in P22_INT8_RUNS:
        held = P22Held()
        save = p22_save_int8(root / f"int8_{name}.pt")

        def after_first(engine, held=held, save=save):
            save(engine)
            held.arm(engine)  # the second window's update

        out[name] = p18_run(
            seed, name, kind, "Adam", "fp32", 0.0, 1e-4, mesh, shapes,
            extra=dict(P22_INT8, zero_optimization={"stage": stage}),
            after_first=after_first, read=held.read)
    shapes.clear()
    engine = p22_offload_engine(seed, P22_WORLD)
    got = p16_windows(engine, seed, p22_save_int8(
        root / "int8_mp2_int8_offload.pt"))
    got["kernel_shapes"] = sorted([n, list(s)] for n, s in shapes)
    got["host_gb"] = p22_host_gb(engine)
    got["coords"] = [engine.data_rank, engine.model_rank]
    out["mp2_int8_offload"] = got
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    out["serve"] = p22_serve(seed, P22_WORLD)
    Path(spec["out"]).write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def phase22c_rank(spec_path):
    """One of phase 22(c)'s eight ranks (pp 2 x dp 4) of the gloo group
    the phase makes: one window of the uneven split, float32 Adam at ZeRO
    stage 0, then one with int8 moments at ZeRO stage 3 (rank 0 writes
    its joined int8 state). Writes its results as JSON."""
    import torch.distributed as dist

    spec = json.loads(Path(spec_path).read_text())
    rank, seed = spec["rank"], spec["seed"]
    torch.set_num_threads(1)  # eight processes on the host's cores
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{spec['port']}", rank=rank,
        world_size=P22_PP * P22_DP)
    shapes = p17_record_shapes()
    runs = []
    for extra in (None, P22_INT8_Z3):
        engine = p22_uneven_engine(seed, P22_PP, P22_DP, extra)
        held = P22Held()
        held.arm(engine)
        runs.append(p22_uneven_window(engine, seed))
        runs[-1]["held"] = held.read(engine)
        if extra is not None:
            p22_save_int8(Path(spec["out"]).parent / "int8_c.pt")(engine)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    got, got["int8_z3"] = runs
    got["kernel_shapes"] = sorted([n, list(s)] for n, s in shapes)
    Path(spec["out"]).write_text(json.dumps(got))
    dist.barrier()
    dist.destroy_process_group()


def p22_close(tag, got, want):
    ok = len(got) == len(want) and all(
        math.isclose(a, b, rel_tol=P18_RTOL) for a, b in zip(got, want))
    if not ok:
        fail(f"phase 22 {tag}: {got} != {want} (rtol {P18_RTOL})")


def p22_check_kernels(seed):
    """The attention kernels of phase 22's training paths against their
    plain versions, float32 as the paths run them (causal, dropout 0): an
    expert rank's [4, 12, 1024, 64], a model rank's [2, 6, 1024, 64] and
    (c)'s 3-row piece [3, 12, 1024, 64]. Returns the max errors."""
    from deepspeed_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed + 2222)
    errs = {}
    for tag, shape in (("ep2", P18_SHAPES["ep2"]), ("mp2", P22_MP_SHAPE),
                       ("pp2 x dp4", P22_UNEVEN_SHAPE)):
        q, k, v, dout = (torch.randn(shape, device="cuda", generator=gen)
                         for _ in range(4))
        args = (q, k, v, None, True, None, 0.0, 2222)
        out, _ = A.flash_fwd(*args)
        ref, ref_lse = A.flash_fwd_plain(*args)
        name = f"phase 22 {tag} float32 {list(shape)}"
        errs["flash_fwd"] = max(errs.get("flash_fwd", 0.0), check_close(
            f"{name} flash_fwd", out, ref, torch.float32))
        delta = (dout * ref).sum(dim=-1)
        bargs = (q, k, v, None, dout, ref_lse, delta, True, None, 0.0, 2222)
        got = (A.flash_bwd_dq(*bargs), *A.flash_bwd_dkv(*bargs))
        want = (A.flash_bwd_dq_plain(*bargs), *A.flash_bwd_dkv_plain(*bargs))
        for what, a, b in zip(("flash_bwd_dq", "dk", "dv"), got, want):
            key = "flash_bwd_dq" if what == "flash_bwd_dq" else "flash_bwd_dkv"
            errs[key] = max(errs.get(key, 0.0), check_close(
                f"{name} {what}", a, b, torch.float32))
        del q, k, v, dout, out, ref, got, want
    return errs


def p22_int8(seed, ranks, launches, root):
    """(a): each rank's int8 runs against one rank's int8 run of the same
    model (launches at the paths' shapes, losses within P18_RTOL, the int8
    first moment joined over the ranks against one rank's; the bytes an
    expert rank holds at ZeRO stage 3 beside stage 0's, each under it)."""
    from deepspeed_tpu_torch.ops import attention as A

    check = A._check_cuda
    one, refs = {}, {}
    for name, kind, _, ref_kind, _ in P22_INT8_RUNS:
        if ref_kind not in refs:
            shapes = p17_record_shapes()
            leaves = {}
            try:
                got = p18_run(
                    seed, f"{ref_kind}_int8", ref_kind, "Adam", "fp32", 0.0,
                    1e-4, None, shapes, extra=P22_INT8,
                    after_first=lambda e: leaves.update(p22_int8_leaves(e)))
            finally:
                A._check_cuda = check
            refs[ref_kind] = got, leaves
            p18_check_run(f"{ref_kind} int8 one rank", got, N_LAYER,
                          P18_WINDOWS, 0, P18_SHAPES["moe"], phase="22")
            for k, n in got["launches"].items():
                launches[k][f"p22_{ref_kind}_int8"] = n
        got, leaves = refs[ref_kind]
        path = root / f"int8_{name}.pt"
        one[name] = dict(got, int8_vs_one_rank=p22_compare_int8(
            f"{name} rank 0", torch.load(path), leaves))
        path.unlink()
        for rank, r in enumerate(ranks):
            mine = r[name]
            pp = kind == "pp"
            p18_check_run(f"{name} rank {rank} (pipe, data "
                          f"{tuple(mine['coords'])})", mine,
                          N_LAYER // P22_WORLD if pp else N_LAYER,
                          (P18_MICROBATCHES if pp else 1) * P18_WINDOWS, 0,
                          P18_SHAPES["pp2" if pp else "ep2"], phase="22")
            for k, n in mine["launches"].items():
                launches[k][f"p22_{name}_rank{rank}"] = n
        if ranks[0][name]["losses"] != ranks[1][name]["losses"]:
            fail(f"phase 22 {name}: the ranks return different losses")
        p22_close(f"float32 {name} vs one rank's int8 losses",
                  ranks[0][name]["losses"], got["losses"])
    for rank, r in enumerate(ranks):
        z3, z0 = r["ep2_int8_z3"]["held"], r["ep2_int8"]["held"]
        if (z3["zero_stage"], z0["zero_stage"]) != (3, 0):
            fail(f"phase 22 ep2 int8 rank {rank}: ZeRO stages "
                 f"{z3['zero_stage']}, {z0['zero_stage']}, want 3, 0")
        log(p22_held_line(f"ep2 int8 rank {rank}", z3, z0))
        p22_check_held(f"ep2 int8 rank {rank}", z3, z0)
    return one


def p22_offload(seed, ranks, launches, root):
    """(b): int8 moments at mp 2 with offload against mp 1's."""
    micro_steps = P16_WINDOWS * P16_ACCUM
    for rank, r in enumerate(ranks):
        got = r["mp2_int8_offload"]
        if not all(math.isfinite(v) for v in got["losses"]) or got["skipped"]:
            fail(f"phase 22 mp 2 int8 offload rank {rank}: losses "
                 f"{got['losses']}")
        for k in TRAIN_KERNELS:
            if got["launches"][k] != N_LAYER * micro_steps:
                fail(f"phase 22 mp 2 int8 offload rank {rank}: {k} launched "
                     f"{got['launches'][k]} times, want "
                     f"{N_LAYER * micro_steps}")
        shapes = {tuple(s) for _, s in got["kernel_shapes"]}
        if shapes != {P22_MP_SHAPE}:
            fail(f"phase 22 mp 2 int8 offload rank {rank}: attention "
                 f"kernels at {sorted(shapes)}, want {P22_MP_SHAPE}")
        for k, n in got["launches"].items():
            launches[k][f"p22_mp2_int8_offload_rank{rank}"] = n
        log(f"  int8 offload mp 2 rank {rank} (model rank "
            f"{got['coords'][1]}): losses {got['losses']}; the card holds "
            f"{got['held_gb']:.4f} GB, peak {got['peak_gb']:.4f} GB; the "
            f"host's masters and moments {got['host_gb']:.4f} GB; "
            f"{got['window_s']:.3f} s a window")
    if ranks[0]["mp2_int8_offload"]["losses"] != ranks[1][
            "mp2_int8_offload"]["losses"]:
        fail("phase 22 mp 2 int8 offload: the model ranks return different "
             "losses")
    engine = p22_offload_engine(seed, 1)
    leaves = {}
    ref = p16_windows(engine, seed,
                      lambda e: leaves.update(p22_int8_leaves(e)))
    ref["host_gb"] = p22_host_gb(engine)
    path = root / "int8_mp2_int8_offload.pt"
    ref["int8_vs_mp1"] = p22_compare_int8("mp 2 int8 offload rank 0",
                                          torch.load(path), leaves)
    path.unlink()
    del engine, leaves
    gc.collect()
    torch.cuda.empty_cache()
    for k, n in ref["launches"].items():
        launches[k]["p22_mp1_int8_offload"] = n
    log(f"  int8 offload mp 1: losses {ref['losses']}; the card holds "
        f"{ref['held_gb']:.4f} GB, peak {ref['peak_gb']:.4f} GB; the host "
        f"{ref['host_gb']:.4f} GB; {ref['window_s']:.3f} s a window")
    p22_close("float32 int8 offload mp 2 vs mp 1 losses",
              ranks[0]["mp2_int8_offload"]["losses"], ref["losses"])
    return {k: ref[k] for k in ("losses", "held_gb", "peak_gb", "host_gb",
                                "window_s", "int8_vs_mp1")}


def p22_uneven(seed, root, launches):
    """(c): pp 2 x dp 4 on eight ranks of the card against pp 1 on the
    same global batch."""
    t0 = time.monotonic()
    ranks = p14_spawn(seed, root, timeout_s=420, flag="--phase22c-rank",
                      phase="22(c)", world=P22_PP * P22_DP)
    spawn_s = time.monotonic() - t0
    per = P22_ROWS // P22_MICROBATCHES
    for rank, both in enumerate(ranks):
        shapes = {tuple(s) for _, s in both["kernel_shapes"]}
        if shapes != {P22_UNEVEN_SHAPE}:
            fail(f"phase 22(c) rank {rank}: attention kernels at "
                 f"{sorted(shapes)}, want {P22_UNEVEN_SHAPE}")
        for tag, got in (("", both), ("int8_", both["int8_z3"])):
            pipe, data = got["coords"]
            if (pipe, data) != (rank // P22_DP, rank % P22_DP):
                fail(f"phase 22(c) rank {rank}: coordinates {got['coords']}")
            first = data * (P22_ROWS // P22_DP) // per
            want_plan = [P22_MICROBATCHES, 1, first, [P22_ROWS // P22_DP]]
            if got["plan"] != want_plan:
                fail(f"phase 22(c) {tag}rank {rank}: plan {got['plan']}, "
                     f"want {want_plan}")
            if (not all(math.isfinite(v) for v in got["losses"])
                    or got["skipped"]):
                fail(f"phase 22(c) {tag}rank {rank}: losses {got['losses']}")
            for k in TRAIN_KERNELS:
                if got["launches"][k] != P22_LAYERS // P22_PP:
                    fail(f"phase 22(c) {tag}rank {rank}: {k} launched "
                         f"{got['launches'][k]} times, want "
                         f"{P22_LAYERS // P22_PP}")
            for k, n in got["launches"].items():
                launches[k][f"p22c_{tag}rank{rank}"] = n
    for tag, runs in (("", ranks), (" int8 ZeRO 3", [r["int8_z3"]
                                                     for r in ranks])):
        if any(r["losses"] != runs[0]["losses"] for r in runs):
            fail(f"phase 22(c){tag}: the ranks return different losses "
                 f"{[r['losses'] for r in runs]}")
    engine = p22_uneven_engine(seed, 1, 1)
    ref = p22_uneven_window(engine, seed)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    p22_close("(c) float32 pp 2 x dp 4 vs pp 1 losses", ranks[0]["losses"],
              ref["losses"])
    engine = p22_uneven_engine(seed, 1, 1, P22_INT8)
    ref_int8 = p22_uneven_window(engine, seed)
    ref_int8["int8_vs_pp1"] = p22_compare_int8(
        "(c) int8 ZeRO 3 rank 0", torch.load(root / "int8_c.pt"),
        p22_int8_leaves(engine))
    (root / "int8_c.pt").unlink()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    p22_close("(c) float32 int8 ZeRO 3 pp 2 x dp 4 vs pp 1 int8 losses",
              ranks[0]["int8_z3"]["losses"], ref_int8["losses"])
    for rank, got in enumerate(ranks):
        z3 = got["int8_z3"]
        if z3["held"]["zero_stage"] != 3 or got["held"]["zero_stage"] != 0:
            fail(f"phase 22(c) rank {rank}: ZeRO stages "
                 f"{z3['held']['zero_stage']}, {got['held']['zero_stage']}")
        log(p22_held_line(f"(c) rank {rank} (pipe, data {tuple(z3['coords'])})"
                          f" int8", z3["held"], got["held"]))
        p22_check_held(f"(c) rank {rank}", z3["held"], got["held"])
    log(f"  (c) pp 2 x dp 4, {P22_ROWS} rows in {P22_MICROBATCHES} "
        f"microbatches (3-row pieces): loss {ranks[0]['losses']} vs pp 1 "
        f"{ref['losses']}; a rank held {max(r['held_gb'] for r in ranks):.4f}"
        f" GB, peak {max(r['peak_gb'] for r in ranks):.4f} GB; the window "
        f"{max(r['window_s'] for r in ranks):.3f} s; int8 ZeRO 3 loss "
        f"{ranks[0]['int8_z3']['losses']} vs pp 1 int8 "
        f"{ref_int8['losses']}, a rank's peak "
        f"{max(r['int8_z3']['peak_gb'] for r in ranks):.4f} GB, the window "
        f"{max(r['int8_z3']['window_s'] for r in ranks):.3f} s; the eight "
        f"ranks {spawn_s:.1f} s from spawn to exit")
    return {"ranks": ranks, "pp1": ref, "pp1_int8": ref_int8,
            "spawn_s": spawn_s}


def p22_serving(seed, ranks, launches):
    """(d): serving at dp 2 against one engine."""
    from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel

    lead = ranks[0]["serve"]
    st = lead["stats"]
    if [r["serve"]["coords"] for r in ranks] != [[0, 0, 0], [1, 1, 0]] or (
            [r["serve"]["leader"] for r in ranks] != [True, False]):
        fail(f"phase 22 serving dp 2: coordinates "
             f"{[r['serve']['coords'] for r in ranks]}")
    ref = p22_serve(seed, 1)
    vocab = GPT2Config.small().vocab_size
    prompts, _ = p22_prompts(seed, vocab)
    model = GPT2LMHeadModel(GPT2Config.small(dropout=0.0), device="cuda",
                            seed=seed)
    model.eval()
    same_tokens("phase 22 float32 serving dp 2 vs one engine", prompts,
                lead["tokens"], ref["tokens"], model, vocab)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    if st["prefix_hits"] < 1:
        fail(f"phase 22 serving dp 2: no prefix hit ({st})")
    p20_check_launches("phase 22 one engine", ref["launches"], ref["stats"],
                       sgmv=True)
    for k, n in ref["launches"].items():
        launches[k]["p22_serve_dp1"] = n
    for rank, r in enumerate(ranks):
        got = r["serve"]
        # every rank runs the leader's plans: its launches are 12 a cold
        # prefill and 12 (SGMV 48) a decode step of the leader's counts
        p20_check_launches(f"phase 22 serving dp 2 rank {rank}",
                           got["launches"], st, sgmv=True)
        for k, n in got["launches"].items():
            launches[k][f"p22_serve_dp2_rank{rank}"] = n
        log(f"  serving dp 2 rank {rank}: launches "
            + ", ".join(f"{k} {got['launches'][k]}" for k in
                        ("flash_fwd", "paged_decode", "sgmv"))
            + f"; holds weights {got['weights_gb']:.4f} GB, KV pool "
            f"{got['kv_pool_gb']:.4f} GB {got['kv_pool_shape']}, adapter "
            f"pool {got['adapter_pool_gb']:.4f} GB (allocated "
            f"{got['held_gb']:.4f} GB; one engine {ref['held_gb']:.4f} GB)")
    log(f"  serving dp 2: {st['cold_prefills']} cold prefills, "
        f"{st['prefix_hits']} prefix hits, {st['decode_steps']} decode "
        f"steps; float32 tokens equal one engine's")
    return {"ranks": [{k: v for k, v in r["serve"].items() if k != "tokens"}
                      for r in ranks],
            "dp1": {k: v for k, v in ref.items() if k != "tokens"}}


def phase_int8_uneven_serve_dp(seed, card):
    """Phase 22. Returns ({kernel: {path: launches}}, stats)."""
    t0 = time.monotonic()
    root = Path("build") / "phase22"
    shutil.rmtree(root, ignore_errors=True)
    (root / "c").mkdir(parents=True)
    launches = {name: {} for name in launch_counters()}
    ranks = p14_spawn(seed, root, timeout_s=600, flag="--phase22-rank",
                      phase="22", world=P22_WORLD)
    stats = {"card": card, "ranks": ranks}
    stats["one_rank_int8"] = p22_int8(seed, ranks, launches, root)
    stats["offload_mp1"] = p22_offload(seed, ranks, launches, root)
    stats["serving"] = p22_serving(seed, ranks, launches)
    stats["uneven"] = p22_uneven(seed, root / "c", launches)
    stats["kernels_vs_plain"] = dict(
        p22_check_kernels(seed),
        **p20_check_kernels(seed, phase=22, sgmv=True))
    stats["wall_s"] = time.monotonic() - t0
    one = stats["one_rank_int8"]
    log(f"phase 22: int8 pp 2 = one rank ({ranks[0]['pp2_int8']['losses']} "
        f"vs {one['pp2_int8']['losses']}); int8 ep 2 = one rank "
        f"({ranks[0]['ep2_int8']['losses']} vs {one['ep2_int8']['losses']});"
        f" at ZeRO 3 ({ranks[0]['ep2_int8_z3']['losses']}); int8 offload "
        f"mp 2 = mp 1 ({ranks[0]['mp2_int8_offload']['losses']} vs "
        f"{stats['offload_mp1']['losses']}); pp 2 x dp 4 = pp 1, with int8 "
        f"at ZeRO 3 too; serving dp 2 = one engine; {stats['wall_s']:.1f} s "
        f"({card})")
    return launches, stats


def only_flash(device, seed):
    """``--only-flash``: the flash kernels built alone (ptxas's registers
    and spills printed) and timed as time_flash times them (bf16, causal,
    dropout 0) at D = 64, 128 and 256, and the float32 forward (the FMA
    kernel) at the same shapes, through the public wrappers only, so that
    a copy of this script at the root of another checkout times that
    checkout's kernels the same way."""
    from deepspeed_tpu_torch.ops import attention as A
    from deepspeed_tpu_torch.ops import kernel_lib

    built = kernel_lib.build(["flash_fwd", "flash_bwd"])
    for name, report in built.items():
        for line in report.splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log(f"  {name}: {line.strip()}")
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    timer = Timer(device)
    out = {}
    for tag, (b, h, s, d) in FLASH_SHAPES.items():
        q, k, v, dout = (torch.randn(b, h, s, d, device=device, generator=gen)
                         .to(torch.bfloat16) for _ in range(4))
        out[tag] = time_flash(timer, q, k, v, dout,
                              f"B={b} H={h} S={s} D={d} causal bf16")
        q32, k32, v32 = (t.float() for t in (q, k, v))
        call = lambda: A.flash_fwd(q32, k32, v32, None, True)
        out[tag]["flash_fwd f32"] = dict(
            shape=f"B={b} H={h} S={s} D={d} causal float32",
            ms=timer.ms(call, iters=10),
            device_ms=timer.ms(call, iters=10, spin=True))
        for name, entry in out[tag].items():
            log(f"  {name} {tag}: device_ms {entry['device_ms']:.5f} "
                f"ms {entry['ms']:.5f}")
        del q, k, v, dout, q32, k32, v32
        torch.cuda.empty_cache()
    return out


def only_bert_attention(device, seed):
    """``--only-bert-attention``: the flash kernels built alone (ptxas's
    registers and spills printed), phase 12a's checks against the plain
    versions (BERT's padding mask and, where this script has them, the
    mask patterns) and rows 1b-3b timed, through the public wrappers
    only, so that a copy of this script at the root of another checkout
    times that checkout's kernels the same way."""
    from deepspeed_tpu_torch.ops import kernel_lib

    built = kernel_lib.build(["flash_fwd", "flash_bwd"])
    for name, report in built.items():
        for line in report.splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                log(f"  {name}: {line.strip()}")
    gen = torch.Generator(device=device).manual_seed(seed + 12)
    timer = Timer(device)
    errs = check_flash_bert(device, gen)
    _, checks = check_flash_mask_patterns(device, gen)
    return {"rows": time_flash_bert(device, gen, timer, errs),
            "mask_pattern_checks": checks}


def only_kernels(device, seed):
    """``--only-kernels``: LAMB phase 1 (rows 4-5) and SGMV (row 7) built
    alone and timed as phases 3b and 3c time them, through the public
    wrappers only, so that a copy of this script at the root of another
    checkout times that checkout's kernels the same way."""
    from deepspeed_tpu_torch.ops import kernel_lib

    built = kernel_lib.build(["lamb_phase1", "sgmv"])
    for name, report in built.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    timer = Timer(device)
    lamb = time_lamb(device, timer, lamb_operands(device, gen, seed))
    sgmv = time_sgmv(device, gen, timer, batches=(8,))
    host = sgmv_host_costs(device, gen)
    log(f"  sgmv host time per call: {json.dumps(host)}")
    return {"lamb_phase1": lamb, "sgmv": sgmv, "sgmv_host": host}


def main():
    if sys.argv[1:2] == ["--phase15-rank"]:
        # a rank the port's runner started: its own arguments
        # (add_config_arguments), the card required
        if not torch.cuda.is_available():
            print("FAIL: no CUDA device", file=sys.stderr)
            sys.exit(2)
        phase15_launched_rank(sys.argv[1:])
        return
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only-decode", action="store_true",
                        help="build and check paged decode alone and print "
                        "its timings (to time another checkout the same "
                        "way)")
    parser.add_argument("--only-flash", action="store_true",
                        help="build the flash kernels alone and print their "
                        "timings at D = 64, 128 and 256 (to time another "
                        "checkout the same way)")
    parser.add_argument("--only-bert-attention", action="store_true",
                        help="build the flash kernels alone, check them "
                        "under BERT's padding mask and the mask patterns "
                        "and print rows 1b-3b's timings (to time another "
                        "checkout the same way)")
    parser.add_argument("--only-kernels", action="store_true",
                        help="build LAMB phase 1 and SGMV alone and print "
                        "their timings (to time another checkout the same "
                        "way)")
    parser.add_argument("--only-phase12", action="store_true",
                        help="build every kernel and run phase 12 alone "
                        "(BERT and the optimizer state layouts)")
    parser.add_argument("--only-phase13", action="store_true",
                        help="build every kernel and run phase 13 alone "
                        "(the contiguous cache, the host tier and "
                        "speculative decoding)")
    parser.add_argument("--only-phase14", action="store_true",
                        help="build every kernel and run phase 14 alone "
                        "(data parallel: ZeRO stages 0-3 on two ranks)")
    parser.add_argument("--only-phase15", action="store_true",
                        help="build every kernel and run phase 15 alone "
                        "(the launcher, and A6b: compensated masters and "
                        "adapters at dp 2, zero3_gathered, BERT LoRA and "
                        "use_flash=False, stochastic_mode)")
    parser.add_argument("--only-phase16", action="store_true",
                        help="build every kernel and run phase 16 alone "
                        "(tensor parallelism: GPT-2 small at mp 2 on two "
                        "ranks of the card)")
    parser.add_argument("--only-phase17", action="store_true",
                        help="build every kernel and run phase 17 alone "
                        "(serving GPT-2 small at mp 2 and training it at "
                        "sp 2, each on two ranks of the card)")
    parser.add_argument("--only-phase18", action="store_true",
                        help="build every kernel and run phase 18 alone "
                        "(GPT-2 small with 8 MoE experts on one rank and "
                        "over a data axis of 2, and over a pipe axis of 2)")
    parser.add_argument("--only-phase19", action="store_true",
                        help="build every kernel and run phase 19 alone "
                        "(int8 moments and compensated masters at sp 2 on "
                        "two ranks of the card; the flash tile autotuner "
                        "and the forward's tile forms)")
    parser.add_argument("--only-phase20", action="store_true",
                        help="build every kernel and run phase 20 alone "
                        "(the serving fleet on one host: in-process and "
                        "subprocess replicas, rolling restart, brownout, "
                        "multi-LoRA and the HTTP door)")
    parser.add_argument("--only-phase21", action="store_true",
                        help="build every kernel and run phase 21 alone "
                        "(the networked fleet: a node agent process over "
                        "TCP, chaos, the journal's recovery, the "
                        "autoscaler and the hub)")
    parser.add_argument("--only-phase22", action="store_true",
                        help="build every kernel and run phase 22 alone "
                        "(int8 moments at pp 2, at MoE ep 2 and at mp 2 "
                        "with offload; pp 2 x dp 4 with uneven "
                        "microbatches on eight ranks; serving at dp 2)")
    parser.add_argument("--phase22-rank", metavar="SPEC",
                        help=argparse.SUPPRESS)
    parser.add_argument("--phase22c-rank", metavar="SPEC",
                        help=argparse.SUPPRESS)
    parser.add_argument("--phase21-router", metavar="SPEC",
                        help=argparse.SUPPRESS)
    parser.add_argument("--phase14-rank", metavar="SPEC",
                        help=argparse.SUPPRESS)
    parser.add_argument("--phase19-rank", metavar="SPEC",
                        help=argparse.SUPPRESS)
    parser.add_argument("--phase18-rank", metavar="SPEC",
                        help=argparse.SUPPRESS)
    parser.add_argument("--phase17-rank", metavar="SPEC",
                        help=argparse.SUPPRESS)
    parser.add_argument("--phase16-rank", metavar="SPEC",
                        help=argparse.SUPPRESS)
    parser.add_argument("--phase15b-rank", metavar="SPEC",
                        help=argparse.SUPPRESS)
    parser.add_argument("--cold-telemetry", action="store_true",
                        help="one telemetry-on training run whose first "
                        "window builds the kernels in an empty build "
                        "directory, under a 5 s watchdog")
    args = parser.parse_args()

    # phase 1: probe
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        sys.exit(2)
    if args.phase14_rank:
        phase14_rank(args.phase14_rank)
        return
    if args.phase15b_rank:
        phase15b_rank(args.phase15b_rank)
        return
    if args.phase16_rank:
        phase16_rank(args.phase16_rank)
        return
    if args.phase17_rank:
        phase17_rank(args.phase17_rank)
        return
    if args.phase18_rank:
        phase18_rank(args.phase18_rank)
        return
    if args.phase19_rank:
        phase19_rank(args.phase19_rank)
        return
    if args.phase21_router:
        phase21_router(args.phase21_router)
        return
    if args.phase22_rank:
        phase22_rank(args.phase22_rank)
        return
    if args.phase22c_rank:
        phase22c_rank(args.phase22c_rank)
        return
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

    if args.only_decode:
        built = kernel_lib.build(["paged_decode"])
        for line in built.get("paged_decode", "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {line.strip()}")
        gen = torch.Generator(device=device).manual_seed(args.seed)
        entry = phase_decode(device, gen, Timer(device))
        print(json.dumps({"paged_decode": entry, "card": smi}))
        return

    if args.only_flash:
        print(json.dumps({"only_flash": only_flash(device, args.seed),
                          "checkout": str(Path(__file__).resolve().parent),
                          "card": smi}))
        return

    if args.only_bert_attention:
        print(json.dumps({"only_bert_attention": only_bert_attention(
            device, args.seed),
                          "checkout": str(Path(__file__).resolve().parent),
                          "card": smi}))
        return

    if args.only_kernels:
        print(json.dumps({"only_kernels": only_kernels(device, args.seed),
                          "checkout": str(Path(__file__).resolve().parent),
                          "card": smi}))
        return

    if args.cold_telemetry:
        print(json.dumps({"cold_telemetry": cold_build_telemetry(args.seed,
                                                                 smi),
                          "card": smi}))
        return

    if args.only_phase12:
        kernel_lib.build()
        launches, stats, rows = phase_bert_layouts(args.seed, smi)
        print(json.dumps({"phase12": stats, "rows": rows,
                          "launches": launches, "card": smi}))
        return

    if args.only_phase14:
        kernel_lib.build()
        launches, stats = phase_data_parallel(args.seed, smi)
        print(json.dumps({"phase14": stats, "launches": launches,
                          "card": smi}))
        return

    if args.only_phase15:
        kernel_lib.build()
        launches, stats = phase_launcher_and_refusals(args.seed, smi)
        print(json.dumps({"phase15": stats, "launches": launches,
                          "card": smi}))
        return

    if args.only_phase16:
        kernel_lib.build()
        launches, stats = phase_model_parallel(args.seed, smi)
        print(json.dumps({"phase16": stats, "launches": launches,
                          "card": smi}))
        return

    if args.only_phase17:
        kernel_lib.build()
        launches, stats = phase_serve_and_sequence(args.seed, smi)
        print(json.dumps({"phase17": stats, "launches": launches,
                          "card": smi}))
        return

    if args.only_phase18:
        kernel_lib.build()
        launches, stats = phase_moe_and_pipeline(args.seed, smi)
        print(json.dumps({"phase18": stats, "launches": launches,
                          "card": smi}))
        return

    if args.only_phase19:
        kernel_lib.build()
        launches, stats = phase_parallel_lifted_and_autotune(args.seed, smi)
        print(json.dumps({"phase19": stats, "launches": launches,
                          "card": smi}))
        return

    if args.only_phase20:
        kernel_lib.build()
        launches, stats = phase_fleet(args.seed, smi)
        print(json.dumps({"phase20": stats, "launches": launches,
                          "card": smi}))
        return

    if args.only_phase21:
        kernel_lib.build()
        launches, stats = phase_fleet_net(args.seed, smi)
        print(json.dumps({"phase21": stats, "launches": launches,
                          "card": smi}))
        return

    if args.only_phase22:
        kernel_lib.build()
        launches, stats = phase_int8_uneven_serve_dp(args.seed, smi)
        print(json.dumps({"phase22": stats, "launches": launches,
                          "card": smi}))
        return

    if args.only_phase13:
        kernel_lib.build()
        launches, stats = phase_inference_rest(args.seed, smi)
        print(json.dumps({"phase13": stats, "launches": launches,
                          "card": smi}))
        return

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
    log("phase 2: ptxas registers and spills of the forward, dQ and dK/dV "
        "at D = 128 and of dK/dV at D = 256")
    check_spills()
    log("phase 2: the kernel each D = 256 call launches (torch.profiler)")
    routes = check_wide_routes(device)

    seconds = {"1-2": time.monotonic() - T_START}

    def timed(tag, fn, *fn_args):
        t_fn = time.monotonic()
        out = fn(*fn_args)
        seconds[tag] = time.monotonic() - t_fn
        return out

    kernels = timed("3", phase_kernels, device, args.seed)
    timed("3b", phase_train_kernels, device, args.seed, kernels)
    timed("3c", phase_sgmv_kernels, device, args.seed, kernels)
    serve_launches, slice_stats = timed("4", phase_slice, args.seed, smi)
    launches, train_stats = timed("5", phase_train, args.seed, smi)
    adapter_launches, adapter_stats = timed("6", phase_adapters, args.seed,
                                            smi)
    hd_launches, hd_stats = timed("7", phase_head_dims, args.seed, smi)
    tel_launches, tel_stats = timed("8", phase_telemetry, args.seed, smi)
    res_launches, res_stats = timed("10", phase_resilience, args.seed, smi)
    data_launches, data_stats = timed("11", phase_data_remat, args.seed, smi)
    bert_launches, bert_stats, bert_rows = timed(
        "12", phase_bert_layouts, args.seed, smi)
    inf_launches, inf_stats = timed("13", phase_inference_rest, args.seed,
                                    smi)
    dp_launches, dp_stats = timed("14", phase_data_parallel, args.seed, smi)
    a6b_launches, a6b_stats = timed("15", phase_launcher_and_refusals,
                                    args.seed, smi)
    mp_launches, mp_stats = timed("16", phase_model_parallel, args.seed, smi)
    sp_launches, sp_stats = timed("17", phase_serve_and_sequence, args.seed,
                                  smi)
    moe_launches, moe_stats = timed("18", phase_moe_and_pipeline, args.seed,
                                    smi)
    a7f_launches, a7f_stats = timed(
        "19", phase_parallel_lifted_and_autotune, args.seed, smi)
    fleet_launches, fleet_stats = timed("20", phase_fleet, args.seed, smi)
    net_launches, net_stats = timed("21", phase_fleet_net, args.seed, smi)
    p22_launches, p22_stats = timed("22", phase_int8_uneven_serve_dp,
                                    args.seed, smi)
    by_phase = {k: round(v, 1) for k, v in seconds.items()}
    log(f"seconds by phase: {json.dumps(by_phase)}; "
        f"{time.monotonic() - T_START:.1f} s in all ({smi})")
    for path, counts in [("serve", serve_launches),
                         *adapter_launches.items(), *hd_launches.items(),
                         *tel_launches.items(), *res_launches.items(),
                         *inf_launches.items()]:
        for name, n in counts.items():
            launches[name][path] = n
    for name, by_path in data_launches.items():
        launches[name].update(by_path)
    for name, by_path in bert_launches.items():
        launches[name].update(by_path)
    for name, by_path in dp_launches.items():
        launches[name].update(by_path)
    for name, by_path in a6b_launches.items():
        launches[name].update(by_path)
    for name, by_path in mp_launches.items():
        launches[name].update(by_path)
    for name, by_path in sp_launches.items():
        launches[name].update(by_path)
    for name, by_path in moe_launches.items():
        launches[name].update(by_path)
    for name, by_path in a7f_launches.items():
        launches[name].update(by_path)
    for name, by_path in fleet_launches.items():
        launches[name].update(by_path)
    for name, by_path in net_launches.items():
        launches[name].update(by_path)
    for name, by_path in p22_launches.items():
        launches[name].update(by_path)
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
    kernels["flash_fwd"]["head_dims"] = hd_stats["flash"]
    kernels["paged_decode"]["head_dims"] = {
        hd: e for hd, e in hd_stats["paged_decode"].items()
        if hd not in HD_TAIL}
    # the D = 128 instantiations (head dims 65-128), the D = 256 ones
    # (129-256) and paged decode's tail path (head dims that are not whole
    # 16-byte rows), each with the launches of the phase 7 paths that run
    # them
    for name, src, tpu, which in (
            ("flash_fwd", FLASH_SOURCE, FLASH_TPU, "fwd"),
            ("flash_bwd_dq", BWD_SOURCE, DQ_TPU, "dq"),
            ("flash_bwd_dkv", BWD_SOURCE, DKV_TPU, "dkv")):
        by_path = {p: hd_launches[p][name]
                   for p in ("hd128_train", "hd128_serve")}
        kernels[f"{name} d128"] = dict(
            name=f"{name} d128", route="cuda",
            route_detail=ROUTE[f"{name} d128"] + " (head dims 65-128)",
            source=src, replaces=tpu, tpu_kernel=tpu,
            launches=sum(by_path.values()), launches_by_path=by_path,
            **hd_stats["flash_d128"][name])
        by_path = {p: hd_launches[p][name]
                   for p in ("hd192_train", "hd192_serve")}
        kernels[f"{name} d256"] = dict(
            name=f"{name} d256", route="cuda",
            route_detail=ROUTE[f"{name} d256"] + " (head dims 129-256, "
            "zero-padded)", source=src, replaces=tpu, tpu_kernel=tpu,
            launched_kernel={dt: routes[f"{dt} {which}"]
                             for dt in ("float32", "bfloat16", "float16")},
            launches=sum(by_path.values()), launches_by_path=by_path,
            **hd_stats["flash_wide"][256][name],
            d192=hd_stats["flash_wide"][192][name])
    # the forward's tile forms (phase 19): each form's times and error at
    # the autotuner's shapes, the default form first
    for name, tag in (("flash_fwd", "d64"), ("flash_fwd d128", "d128")):
        kernels[name]["tile_forms"] = a7f_stats["autotune"][tag]
    tail = hd_stats["paged_decode"]
    kernels["paged_decode tail"] = dict(
        name="paged_decode tail", route="cuda",
        route_detail="head dims not a multiple of 16: 8-, 4- or 2-byte "
        "copies, pad lanes zero", source=DECODE_SOURCE,
        replaces=DECODE_TPU, tpu_kernel=DECODE_TPU,
        launches=hd_launches["hd8_serve"]["paged_decode"],
        launches_by_path={"hd8_serve":
                          hd_launches["hd8_serve"]["paged_decode"]},
        **tail[8], library_ms=None, library=None,
        tails={hd: tail[hd] for hd in HD_TAIL})
    # rows 1b-3b: BERT's non-causal padded attention, with the launches of
    # phase 12's BERT paths
    kernels.update(bert_rows)
    log(json.dumps({"slice": slice_stats, "train": train_stats,
                    "adapters": adapter_stats, "card": smi,
                    "telemetry": tel_stats, "resilience": res_stats,
                    "data_remat": data_stats, "bert_layouts": bert_stats,
                    "inference_rest": inf_stats,
                    "data_parallel": dp_stats,
                    "launcher_and_refusals": a6b_stats,
                    "model_parallel": mp_stats,
                    "serve_mp_and_sequence": sp_stats,
                    "moe_and_pipeline": moe_stats,
                    "parallel_lifted_and_autotune": a7f_stats,
                    "fleet": fleet_stats,
                    "fleet_net": net_stats,
                    "int8_uneven_serve_dp": p22_stats,
                    "seconds_by_phase": seconds,
                    "head_dims": {k: v for k, v in hd_stats.items()
                                  if k not in ("flash", "flash_wide",
                                               "flash_d128",
                                               "paged_decode")}}))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

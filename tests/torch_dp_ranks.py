"""Rank processes for the port's data-parallel tests (not a test module).

``spawn(world, cases, workdir)`` starts ``world`` processes of this file,
each with the launcher's environment (``DS_TPU_COORDINATOR_ADDRESS``,
``DS_TPU_NUM_PROCESSES``, ``DS_TPU_PROCESS_ID``), so every spawn also
runs the port's bootstrap: the first ``initialize()`` creates the gloo
group. Each rank runs every case in order and saves ``{case name:
result}`` to ``rank<r>.pt``; ``spawn`` returns the ranks' results. One
spawn per test module carries all of its cases, so each case is counted
without paying a torch start-up of its own.

The data of every case is made here from seeds with numpy (the test
process makes the same global batches for the JAX engine): a window is
``accum`` micro-batches of ``micro * dp`` rows, and rank ``r`` feeds rows
``r*micro:(r+1)*micro`` of each. The ``mp_*`` cases run a data x model
mesh of the world (tensor parallelism, ``mp`` ranks a model line): the
ranks of a line feed their data rank's rows. The ``sp_*`` cases run a
sequence axis (ring and Ulysses attention, and GPT-2 whose engine keeps
each rank's chunk of its data rank's rows), the ``moe_*`` cases an MoE
GPT-2 whose experts shard over the data axis, the ``pp_*`` cases the
GPipe schedule and GPT-2 over a pipe axis (every stage of a line feeds
its data rank's rows), and ``serve_mp`` serves over
a model axis of the world, rank 0 driving ``serve_traffic`` and the
others following its plans.

A spawn's rendezvous store is the test process's own, listening on a
port the kernel picked, held until the spawn ends; the ranks join it as
clients (:func:`start`).
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
IN_DIM, HIDDEN, CLASSES = 16, 64, 10
VOCAB, SEQ = 256, 32


# ---------------------------------------------------------------------------
# data and weights (shared with the JAX side of the tests)
# ---------------------------------------------------------------------------
def mlp_weights(seed=0):
    """The MLP's weights in the JAX layout ({linear, head} x {kernel,
    bias})."""
    rng = np.random.default_rng(seed)
    return {
        "linear": {"kernel": (0.3 * rng.normal(size=(IN_DIM, HIDDEN))
                              ).astype(np.float32),
                   "bias": (0.1 * rng.normal(size=(HIDDEN,))
                            ).astype(np.float32)},
        "head": {"kernel": (0.3 * rng.normal(size=(HIDDEN, CLASSES))
                            ).astype(np.float32),
                 "bias": (0.1 * rng.normal(size=(CLASSES,))
                          ).astype(np.float32)},
    }


def bert_rows(rng, rows, vocab):
    """BERT pretraining rows: ``(ids, padding mask, token types, masked-LM
    labels (-100 where none), next-sentence labels (-1 ignored))``, each
    row padded from a length of its own, about one masked-LM label in
    six."""
    ids = rng.integers(0, vocab, (rows, SEQ)).astype(np.int32)
    lengths = rng.integers(SEQ // 2, SEQ + 1, rows)
    mask = (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int32)
    types = np.zeros((rows, SEQ), np.int32)
    types[:, SEQ // 2:] = 1
    mlm = np.where((rng.random((rows, SEQ)) < 1 / 6) & (mask > 0), ids,
                   -100).astype(np.int32)
    nsp = rng.integers(-1, 2, rows).astype(np.int32)
    return ids, mask, types, mlm, nsp


def bert_qa_rows(rng, rows, vocab):
    """BERT question-answering rows: ``(ids, padding mask, token types,
    start positions, end positions)``, the span inside each row's
    unpadded part."""
    ids, mask, types, _, _ = bert_rows(rng, rows, vocab)
    lengths = mask.sum(axis=1)
    start = (rng.random(rows) * (lengths - 4)).astype(np.int32)
    end = (start + rng.integers(0, 4, rows)).astype(np.int32)
    return ids, mask, types, start, end


def windows(model, steps, accum, rows, seed=0, vocab=VOCAB):
    """``steps`` windows of ``accum`` global micro-batches (``rows`` rows
    each): MLP ``(x, y)``, GPT-2 ``(ids, ids)`` (ids below ``vocab``),
    BERT :func:`bert_rows` and :func:`bert_qa_rows`."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        win = []
        for _ in range(accum):
            if model == "mlp":
                win.append((rng.normal(size=(rows, IN_DIM)).astype(np.float32),
                            rng.integers(0, CLASSES, (rows,)).astype(np.int32)))
            elif model == "bert":
                win.append(bert_rows(rng, rows, vocab))
            elif model == "bert_qa":
                win.append(bert_qa_rows(rng, rows, vocab))
            else:
                ids = rng.integers(0, vocab, (rows, SEQ)).astype(np.int32)
                win.append((ids, ids))
        out.append(win)
    return out


def rank_rows(batch, rank, dp):
    """Rank ``rank``'s rows of a global micro-batch."""
    per = batch[0].shape[0] // dp
    return tuple(x[rank * per:(rank + 1) * per] for x in batch)


def config(stage, opt, dtype, micro, accum, dp, lr=1e-2, **extra):
    cfg = {
        "train_batch_size": micro * accum * dp,
        "train_micro_batch_size_per_gpu": micro,
        "gradient_accumulation_steps": accum,
        "optimizer": {"type": opt, "params": {"lr": lr}},
        "zero_optimization": {"stage": stage},
        "gradient_clipping": 1.0,
        "steps_per_print": 1000,
    }
    if dtype == "int8":
        cfg["data_types"] = {"optimizer_state_dtype": "int8"}
    elif dtype in ("bf16", "fp16"):
        cfg[dtype] = {"enabled": True}
    cfg.update(extra)
    return cfg


# ---------------------------------------------------------------------------
# the port's side (runs in the rank processes)
# ---------------------------------------------------------------------------
def torch_mlp(weights):
    import torch
    import torch.nn.functional as F

    class SimpleModel(torch.nn.Module):
        """tests/unit/simple_model.py's SimpleModel: linear -> head ->
        mean cross-entropy."""

        def __init__(self):
            super().__init__()
            self.linear = torch.nn.Linear(IN_DIM, HIDDEN)
            self.head = torch.nn.Linear(HIDDEN, CLASSES)

        def forward(self, x, y):
            logits = self.head(self.linear(x)).float()
            return F.cross_entropy(logits, y.long())

    m = SimpleModel()
    with torch.no_grad():
        for name in ("linear", "head"):
            getattr(m, name).weight.copy_(
                torch.from_numpy(weights[name]["kernel"].T.copy()))
            getattr(m, name).bias.copy_(
                torch.from_numpy(weights[name]["bias"]))
    return m


def _model(case, workdir):
    import torch

    import deepspeed_tpu_torch as dst

    if case["model"] == "mlp":
        return torch_mlp(mlp_weights(case.get("seed", 0)))
    if case["model"] == "gpt2":
        m = dst.GPT2LMHeadModel(dst.GPT2Config(
            vocab_size=VOCAB, n_positions=SEQ, n_embd=64, n_layer=2,
            n_head=4, dropout=case.get("dropout", 0.0),
            remat=case.get("remat", False),
            remat_policy=case.get("remat_policy", "full")), device="cpu")
    else:
        from deepspeed_tpu_torch.models.bert import BertConfig

        cls = (dst.BertForQuestionAnswering if case["model"] == "bert_qa"
               else dst.BertForPreTraining)
        m = cls(BertConfig(**case["bert"]), device="cpu")
    state = workdir / case.get("weights", "none")
    if state.exists():
        m.load_state_dict(torch.load(state, weights_only=True))
    return m


def _feed(engine, case, rank, dp):
    import torch

    losses = []
    for win in windows(case["model"], case["steps"], case["accum"],
                       case["micro"] * dp, case.get("data_seed", 0),
                       vocab=case.get("vocab", VOCAB)):
        mine = [tuple(torch.from_numpy(x) for x in rank_rows(b, rank, dp))
                for b in win]
        losses.append(float(engine.train_batch(iter(mine))))
    return losses


def case_train(case, rank, dp, workdir):
    import deepspeed_tpu_torch as dst

    import torch

    # the engine's model_parameters (a state dict file: e.g. the base and
    # a LoRA adapter to fine-tune), else the model's own weights
    state = case.get("model_parameters")
    engine, *_ = dst.initialize(
        model=_model(case, workdir), device="cpu",
        model_parameters=(None if state is None else torch.load(
            workdir / state, weights_only=True)),
        config_params=config(case["stage"], case["opt"], case["dtype"],
                             case["micro"], case["accum"], dp,
                             lr=case.get("lr", 1e-2), **case.get("extra", {})))
    out = {"losses": _feed(engine, case, rank, dp),
           "skipped": engine.skipped_steps,
           "coeffs": [float(c) for c in engine.lamb_coeffs],
           "zero3_bytes": (engine._zero3_shard_bytes,
                           engine._zero3_gather_bytes),
           "zero3_armed": engine.zero3_gather_enabled}
    full = engine.full_parameters()
    if rank == 0:
        out["params"] = {n: p.detach().float().numpy().copy()
                         for n, p in full.items()}
    return out


def case_overflow(case, rank, dp, workdir):
    """fp16: rank 1's micro-batch holds an inf; every rank must skip."""
    import torch

    import deepspeed_tpu_torch as dst

    engine, *_ = dst.initialize(
        model=_model(case, workdir), device="cpu",
        config_params=config(case["stage"], "Adam", "fp16", 2, 1, dp,
                             fp16={"enabled": True,
                                   "initial_scale_power": 4}))
    before = {n: p.detach().clone() for n, p in engine.full_parameters().items()}
    x, y = rank_rows(windows("mlp", 1, 1, 2 * dp)[0][0], rank, dp)
    x = torch.from_numpy(x.copy())
    if rank == 1:
        x[0, 0] = float("inf")
    engine.train_batch(iter([(x, torch.from_numpy(y))]))
    after = engine.full_parameters()
    return {"skipped": engine.skipped_steps,
            "global_steps": engine.global_steps,
            "scale": float(engine.loss_scale_state.loss_scale),
            "unchanged": all(torch.equal(before[n], after[n])
                             for n in before)}


def case_dropout(case, rank, dp, workdir):
    """Every rank feeds the SAME rows with dropout on: the ranks' losses
    differ only through their masks."""
    import torch

    import deepspeed_tpu_torch as dst

    engine, *_ = dst.initialize(
        model=_model(case, workdir), device="cpu",
        config_params=config(0, "Adam", "fp32", 2, 1, dp))
    ids = torch.from_numpy(windows("gpt2", 1, 1, 2)[0][0][0]).long()
    loss = engine(ids, ids)
    engine.backward(loss)
    return {"loss": float(loss.detach())}


def case_bert(case, rank, dp, workdir):
    """One micro-step of BERT pretraining at stage 0: the rank's batch,
    its loss, and the gradients summed over the data group (the global
    batch's gradient)."""
    import torch
    import torch.distributed as dist

    import deepspeed_tpu_torch as dst

    engine, *_ = dst.initialize(
        model=_model(case, workdir), device="cpu",
        config_params=config(0, "Adam", "fp32", case["micro"], 1, dp))
    batch = np.load(workdir / case["batch"])
    mine = [torch.from_numpy(batch[k][rank * case["micro"]:
                                      (rank + 1) * case["micro"]])
            for k in ("ids", "mask", "types", "mlm", "nsp")]
    loss = engine(*mine)
    engine.backward(loss)
    total = loss.detach().clone()
    dist.all_reduce(total)
    grads = {}
    for n, g in engine._grad_buffer.items():
        g = g.clone()
        dist.all_reduce(g)
        grads[n] = g.numpy()
    out = {"loss": float(total) / dp}
    if rank == 0:
        out["grads"] = grads
    return out


def case_checkpoint(case, rank, dp, workdir):
    """Train 2 windows and save (``mode`` save), or load; then the eval
    fingerprint and 2 more windows (the second one's loss depends on the
    restored optimizer state). The global batches are the same at every
    data size."""
    import torch

    import deepspeed_tpu_torch as dst

    engine, *_ = dst.initialize(
        model=_model(case, workdir), device="cpu",
        config_params=config(case["stage"], case["opt"], case["dtype"],
                             case["micro_global"] // dp, 1, dp, lr=1e-3,
                             resilience={"enabled": True}))
    out = {}
    data = windows("gpt2", 4, 1, case["micro_global"], 0)
    ckpt = Path(case["dir"])

    def run(win):
        rows = [tuple(torch.from_numpy(x) for x in rank_rows(b, rank, dp))
                for b in win]
        return float(engine.train_batch(iter(rows)))

    if case["mode"] == "save":
        out["train"] = [run(w) for w in data[:2]]
        engine.save_checkpoint(str(ckpt), tag="t2")
        out["files"] = sorted(os.listdir(ckpt / "t2"))
        out["manifest"] = json.loads((ckpt / "t2" / "MANIFEST.json"
                                      ).read_text())["files"]
    else:
        path, _ = engine.load_checkpoint(str(ckpt))
        out["loaded"] = path is not None
        out["global_steps"] = engine.global_steps
    out["fingerprint"] = fingerprint(engine, rank, dp)
    out["resume"] = [run(w) for w in data[2:]]
    return out


def fingerprint(engine, rank, dp):
    """The eval loss of a fixed global batch, averaged over the ranks."""
    import torch
    import torch.distributed as dist

    ids = windows("gpt2", 1, 1, 4, seed=99)[0][0][0]
    per = 4 // dp
    mine = torch.from_numpy(ids[rank * per:(rank + 1) * per]).long()
    engine.eval()
    loss = engine(mine, mine).detach().clone()
    engine.train()
    if dp > 1:
        dist.all_reduce(loss)
    return float(loss) / dp


def case_dist(case, rank, dp, workdir):
    """The bootstrap, the mesh and mpu, and the collectives."""
    import torch
    import torch.distributed as dist

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.runtime import dist as dist_lib

    engine, *_ = dst.initialize(
        model=torch_mlp(mlp_weights()), device="cpu",
        config_params=config(0, "Adam", "fp32", 2, 1, dp))
    mpu = engine.mpu
    out = {
        "backend": dist.get_backend(), "world": dist.get_world_size(),
        "rank": dist.get_rank(), "coords": engine.mesh.coords,
        "dp": mpu.get_data_parallel_world_size(),
        "dp_rank": mpu.get_data_parallel_rank(),
        "mp": mpu.get_model_parallel_world_size(),
        "mp_rank": mpu.get_model_parallel_rank(),
        "group_size": dist.get_world_size(mpu.get_data_parallel_group()),
        "mp_group": mpu.get_model_parallel_group(),
        "init_again": dist_lib.init_distributed(),
    }
    g = mpu.get_data_parallel_group()
    t = torch.full((4,), float(rank + 1))
    dist_lib.all_reduce(t, g)
    out["all_reduce"] = t.tolist()
    inp = torch.arange(2 * dp, dtype=torch.float32) + 10 * rank
    res = torch.empty(2)
    dist_lib.reduce_scatter(res, inp, g)
    out["reduce_scatter"] = res.tolist()
    gathered = torch.empty(2 * dp)
    handle = dist_lib.all_gather(gathered, torch.full((2,), float(rank)), g,
                                 async_op=True)
    handle.wait()
    out["all_gather"] = gathered.tolist()
    return out


def case_gather_order(case, rank, dp, workdir):
    """Stage 3 at one layer a gather block: the blocks each gather issues
    for, in order, marked forward or backward, over one micro-step, and
    the gathered buffers still referenced between the forward and the
    backward."""
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import stack

    engine, *_ = dst.initialize(
        model=_model(case, workdir), device="cpu",
        config_params=config(3, "Adam", "fp32", 2, 1, dp, **case["extra"]))
    order, made = [], []
    issue = stack._Gathers.issue

    def recording(self, b):
        # the model's stack (the engine gathers wte, wpe and ln_f apart)
        stacked = self.arming is not engine._engine_gather
        if stacked and b not in self.pending and 0 <= b < len(self.blocks):
            order.append(("bwd" if self.backward else "fwd", b))
        issue(self, b)
        made.append(self)

    stack._Gathers.issue = recording
    try:
        ids = torch.from_numpy(rank_rows(
            windows("gpt2", 1, 1, 2 * dp)[0][0], rank, dp)[0]).long()
        loss = engine(ids, ids)
        held = sum(len(g.pending) for g in set(made)
                   if g.arming is not engine._engine_gather)
        engine.backward(loss)
    finally:
        stack._Gathers.issue = issue
    return {"order": order, "pending_after_forward": held}


def sparse_rows(rank, rows=12, cols=5, k=4):
    """Rank ``rank``'s row-sparse gradient: ``k`` of ``rows`` rows."""
    rng = np.random.default_rng(100 + rank)
    dense = np.zeros((rows, cols), np.float32)
    dense[rng.choice(rows, k, replace=False)] = rng.normal(
        size=(k, cols)).astype(np.float32)
    return dense


def case_sparse(case, rank, dp, workdir):
    """The sparse all-reduce of every rank's CSR gradient."""
    import torch

    from deepspeed_tpu_torch.runtime import dist as dist_lib
    from deepspeed_tpu_torch.runtime.sparse import (
        CSRTensor,
        sparse_all_reduce,
    )

    dist_lib.init_distributed(device="cpu")
    csr = CSRTensor.from_dense(torch.from_numpy(sparse_rows(rank)),
                               max_rows=case["max_rows"])
    return {"dense": sparse_all_reduce(csr).numpy()}


def _resilient_mlp(dp, stage, **resilience):
    """An MLP engine at ZeRO ``stage`` with the resilience block
    ``{"enabled": True, **resilience}``."""
    import deepspeed_tpu_torch as dst

    engine, *_ = dst.initialize(
        model=torch_mlp(mlp_weights()), device="cpu",
        config_params=config(stage, "Adam", "fp32", 2, 1, dp,
                             resilience={"enabled": True, **resilience}))
    return engine


def _mlp_window(engine, rank, dp, seed):
    """One window of the MLP's rows (this rank's), its loss."""
    import torch

    batch = windows("mlp", 1, 1, 2 * dp, seed)[0][0]
    mine = tuple(torch.from_numpy(x) for x in rank_rows(batch, rank, dp))
    return float(engine.train_batch(iter([mine])))


def case_preempt(case, rank, dp, workdir):
    """A SIGTERM to rank 1 alone between two windows: at the next step
    boundary every rank drains into the same tag (the drain keeps
    training), and a third window runs on every rank."""
    import signal

    ckpt = workdir / case["dir"]
    engine = _resilient_mlp(dp, 1, preemption={
        "enabled": True, "save_dir": str(ckpt), "exit_after_save": False})
    losses = [_mlp_window(engine, rank, dp, 0)]
    if rank == 1:
        os.kill(os.getpid(), signal.SIGTERM)
    losses.append(_mlp_window(engine, rank, dp, 1))
    saved = sorted(os.listdir(ckpt)) if ckpt.exists() else []
    losses.append(_mlp_window(engine, rank, dp, 2))
    return {"saved": saved, "losses": losses,
            "latest": (ckpt / "latest").read_text() if saved else None,
            "armed": engine.resilience.preemption_armed,
            "global_steps": engine.global_steps}


def case_load_disagree(case, rank, dp, workdir):
    """Two tags saved; a fresh engine on each rank loads from 'latest',
    rank 1 with one injected read fault (no retry), so it alone falls
    back to the older tag: every rank must load nothing. A second load,
    the fault spent, takes the newest tag on every rank."""
    ckpt = workdir / case["dir"]
    engine = _resilient_mlp(dp, 1)
    for step, tag in enumerate(("t1", "t2")):
        _mlp_window(engine, rank, dp, step)
        engine.save_checkpoint(str(ckpt), tag=tag)
    faults = {}
    if rank == 1:
        faults = {"retry": {"max_attempts": 1}, "fault_injection": {
            "enabled": True,
            "faults": [{"site": "checkpoint.read", "times": 1}]}}
    fresh = _resilient_mlp(dp, 1, **faults)
    path, client = fresh.load_checkpoint(str(ckpt))
    out = {"path": path, "client": client, "steps": fresh.global_steps}
    path, _ = fresh.load_checkpoint(str(ckpt))
    out["again"] = Path(path).name if path else None
    out["steps_again"] = fresh.global_steps
    return out


def case_commit_fail(case, rank, dp, workdir):
    """Rank 0's post-save verification fails: every rank raises the
    same error class, and 'latest' is not published."""
    from deepspeed_tpu_torch.resilience import manifest

    ckpt = workdir / case["dir"]
    engine = _resilient_mlp(dp, 1)
    _mlp_window(engine, rank, dp, 0)
    verify = manifest.verify_checkpoint
    if rank == 0:
        manifest.verify_checkpoint = lambda d: (manifest.CORRUPT, "injected")
    try:
        engine.save_checkpoint(str(ckpt), tag="bad")
        raised = None
    except Exception as e:  # the class is the result
        raised = type(e).__name__
    finally:
        manifest.verify_checkpoint = verify
    return {"raised": raised, "latest": (ckpt / "latest").exists()}


# ---------------------------------------------------------------------------
# tensor parallelism: a data x model mesh of ``world`` ranks, ``mp`` of
# them a model line (rank = data_rank * mp + model_rank); rows by data rank
# ---------------------------------------------------------------------------
def mp_config(case, dp, **over):
    """The case's engine config at data size ``dp`` with its model axis."""
    extra = dict(case.get("extra", {}))
    extra["mesh"] = {"model_parallel_size": case["mp"]}
    extra.update(over)
    return config(case.get("stage", 0), case.get("opt", "Adam"),
                  case.get("dtype", "fp32"), case.get("micro", 2),
                  case.get("accum", 1), dp, lr=case.get("lr", 1e-2), **extra)


def mp_engine(case, world, workdir, **over):
    """A GPT-2 engine on a (world / mp) x mp mesh, with the model's
    ``partition_specs`` unless the case says ``specs: False``."""
    import torch

    import deepspeed_tpu_torch as dst

    model = _model(case, workdir)
    specs = dst.partition_specs(model) if case.get("specs", True) else None
    state = case.get("model_parameters")
    engine, *_ = dst.initialize(
        model=model, device="cpu", param_specs=specs,
        model_parameters=(None if state is None else torch.load(
            workdir / state, weights_only=True)),
        config_params=mp_config(case, world // case["mp"], **over))
    return engine


def case_mp_train(case, rank, world, workdir):
    """Train the case's windows on this rank's data rows; rank 0 returns
    the whole (data- and model-gathered) trainable parameters."""
    engine = mp_engine(case, world, workdir)
    out = {"losses": _feed(engine, case, engine.data_rank,
                           engine.dp_world_size),
           "skipped": engine.skipped_steps,
           "coeffs": [float(c) for c in engine.lamb_coeffs],
           "local_shapes": {n: tuple(p.shape)
                            for n, p in engine.module.named_parameters()},
           "coords": (engine.data_rank, engine.model_rank)}
    full = engine.full_parameters()
    if rank == 0:
        out["params"] = {n: p.detach().float().numpy().copy()
                         for n, p in full.items()}
    return out


def mp_fingerprint(engine):
    """The eval loss of a fixed global batch of 4 rows, averaged over the
    data group (every model rank of a line computes the same)."""
    import torch.distributed as dist

    import torch

    dp = engine.dp_world_size
    ids = windows("gpt2", 1, 1, 4, seed=99)[0][0][0]
    per = 4 // dp
    d = engine.data_rank
    mine = torch.from_numpy(ids[d * per:(d + 1) * per]).long()
    engine.eval()
    loss = engine(mine, mine).detach().clone()
    engine.train()
    if dp > 1:
        dist.all_reduce(loss, group=engine._dp_group)
    return float(loss) / dp


def _mp_run(engine, win):
    import torch

    dp, d = engine.dp_world_size, engine.data_rank
    rows = [tuple(torch.from_numpy(x) for x in rank_rows(b, d, dp))
            for b in win]
    return float(engine.train_batch(iter(rows)))


def case_mp_checkpoint(case, rank, world, workdir):
    """``save``: 2 windows then a save to ``dir``; ``load``: load it.
    Either way the eval fingerprint and 2 more windows follow, whose
    second loss reads the restored optimizer state. The global batches
    are the same at every layout."""
    case = dict(case, micro=case["micro_global"] // (world // case["mp"]))
    engine = mp_engine(case, world, workdir,
                       resilience={"enabled": True})
    ckpt = Path(case["dir"])
    data = windows("gpt2", 4, 1, case["micro_global"], 0)
    out = {}
    if case["mode"] == "save":
        out["train"] = [_mp_run(engine, w) for w in data[:2]]
        engine.save_checkpoint(str(ckpt), tag="t2")
        out["files"] = sorted(os.listdir(ckpt / "t2"))
    else:
        path, _ = engine.load_checkpoint(str(ckpt))
        out["loaded"] = path is not None
        out["global_steps"] = engine.global_steps
    out["fingerprint"] = mp_fingerprint(engine)
    out["resume"] = [_mp_run(engine, w) for w in data[2:]]
    return out


def case_mp_dropout(case, rank, world, workdir):
    """One window with dropout 0.1 at mp 2: the loss and every replicated
    parameter after the step are the same on both model ranks (the hidden
    dropouts draw one mask), while the attention seeds differ."""
    import torch

    from deepspeed_tpu_torch.ops.transformer import DropoutRNG

    engine = mp_engine(dict(case, dropout=0.1), world, workdir)
    loss = _mp_run(engine, windows("gpt2", 1, 1, 2 * engine.dp_world_size,
                                   3)[0])
    rng = DropoutRNG(11, "cpu", engine.data_rank, engine.model_rank)
    replicated = {n: p.detach().clone()
                  for n, p in engine.module.named_parameters()
                  if engine._model_dims.get(n) is None}
    return {"loss": loss, "replicated": replicated,
            "keep": rng.keep((4, 8, 64), 0.1),
            "seed": rng.attn_seed()}


def case_mp_pieces(case, rank, world, workdir):
    """The tensor-parallel pieces on a model line of ``world`` ranks: the
    vocab-parallel loss and its gradients, the copy/reduce collectives,
    and partition_activations' partitioned recompute."""
    import torch

    from deepspeed_tpu_torch import checkpointing as act
    from deepspeed_tpu_torch.ops.cross_entropy import (
        vocab_parallel_lm_head_loss,
    )
    from deepspeed_tpu_torch.parallel import tensor as tpl
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    from deepspeed_tpu_torch.parallel.mpu import TorchMpu
    from deepspeed_tpu_torch.runtime import dist as dist_lib

    dist_lib.init_distributed(device="cpu")
    mesh = build_mesh(model_parallel_size=world)
    tp = tpl.TensorParallel(mesh.model_group, world, mesh.model_rank)
    data = np.load(workdir / case["data"])
    out = {}
    # the loss over vocab shards, and the gradients of the hidden states
    # and of this rank's table rows
    h = torch.from_numpy(data["hidden"]).requires_grad_()
    rows = data["table"].shape[0] // world
    table = torch.from_numpy(
        data["table"][rank * rows:(rank + 1) * rows]).requires_grad_()
    loss = vocab_parallel_lm_head_loss(
        h, table, torch.from_numpy(data["labels"]), tp,
        block_rows=case["block_rows"])
    loss.backward()
    out["loss"] = float(loss)
    out["grad_hidden"] = h.grad.numpy().copy()
    out["grad_table"] = table.grad.numpy().copy()
    # the eval logits gathered over the vocab shards
    out["logits"] = tpl.gather_from_region(
        h.detach() @ table.detach().t(), tp).numpy()
    # partition_activations: a checkpointed segment through a parallel
    # region, with and without partitioned inputs
    x = torch.from_numpy(data["x"])
    w = torch.from_numpy(data["w"][:, rank::world].copy())

    kept = {}
    for on in (False, True):
        act.configure(TorchMpu(mesh), partition_activations=on)
        xi = x.clone().requires_grad_()
        wi = w.clone().requires_grad_()  # this rank's columns

        def segment(x):
            # the activation x is the same on every rank of the line (the
            # partitioned inputs are), the weight is the rank's own
            return tpl.reduce_from_region(torch.tanh(
                tpl.copy_to_region(x, tp) @ wi) @ wi.t(), tp)

        saved = []

        def pack(t):
            saved.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y = act.checkpoint(segment, xi)
        (y * y).sum().backward()
        kept[on] = (y.detach().numpy().copy(), xi.grad.numpy().copy(),
                    wi.grad.numpy().copy(), sum(saved))
    act.configure(None, partition_activations=False)
    out["partition"] = kept
    out["input_bytes"] = x.numel() * x.element_size()
    return out


def _mp_resilient(mp, **resilience):
    """The case of a tensor-parallel GPT-2 engine (stage 1) with the
    resilience block, on this spawn's weights."""
    case = {"mp": mp, "model": "gpt2", "weights": "gpt2.pt", "stage": 1,
            "extra": {"resilience": {"enabled": True, **resilience}}}
    return case


def case_mp_preempt(case, rank, world, workdir):
    """At dp 2 x mp 2: a SIGTERM to one rank alone between two windows;
    at the next step boundary every rank drains into the same tag."""
    import signal

    ckpt = workdir / case["dir"]
    engine = mp_engine(_mp_resilient(case["mp"], preemption={
        "enabled": True, "save_dir": str(ckpt), "exit_after_save": False}),
        world, workdir)
    data = windows("gpt2", 3, 1, 2 * engine.dp_world_size, 5)
    losses = [_mp_run(engine, data[0])]
    if rank == case["signalled"]:
        os.kill(os.getpid(), signal.SIGTERM)
    losses.append(_mp_run(engine, data[1]))
    saved = sorted(os.listdir(ckpt)) if ckpt.exists() else []
    losses.append(_mp_run(engine, data[2]))
    return {"saved": saved, "losses": losses,
            "latest": (ckpt / "latest").read_text() if saved else None,
            "global_steps": engine.global_steps}


def case_mp_load_disagree(case, rank, world, workdir):
    """Two tags saved; a fresh engine on each rank loads 'latest', one
    rank with a read fault (no retry) that makes it fall back to the
    older tag: no rank loads. The fault spent, a second load takes the
    newest tag everywhere."""
    ckpt = workdir / case["dir"]
    engine = mp_engine(_mp_resilient(case["mp"]), world, workdir)
    data = windows("gpt2", 2, 1, 2 * engine.dp_world_size, 6)
    for win, tag in zip(data, ("t1", "t2")):
        _mp_run(engine, win)
        engine.save_checkpoint(str(ckpt), tag=tag)
    faults = {}
    if rank == case["faulty"]:
        faults = {"retry": {"max_attempts": 1}, "fault_injection": {
            "enabled": True,
            "faults": [{"site": "checkpoint.read", "times": 1}]}}
    fresh = mp_engine(_mp_resilient(case["mp"], **faults), world,
                      workdir)
    path, _ = fresh.load_checkpoint(str(ckpt))
    out = {"path": path, "steps": fresh.global_steps}
    path, _ = fresh.load_checkpoint(str(ckpt))
    out["again"] = Path(path).name if path else None
    out["steps_again"] = fresh.global_steps
    return out


def case_mp_commit_fail(case, rank, world, workdir):
    """Rank 0's post-save verification fails: every rank raises the same
    class and 'latest' is not published."""
    from deepspeed_tpu_torch.resilience import manifest

    ckpt = workdir / case["dir"]
    engine = mp_engine(_mp_resilient(case["mp"]), world, workdir)
    _mp_run(engine, windows("gpt2", 1, 1, 2 * engine.dp_world_size, 7)[0])
    verify = manifest.verify_checkpoint
    if rank == 0:
        manifest.verify_checkpoint = lambda d: (manifest.CORRUPT, "injected")
    try:
        engine.save_checkpoint(str(ckpt), tag="bad")
        raised = None
    except Exception as e:  # the class is the result
        raised = type(e).__name__
    finally:
        manifest.verify_checkpoint = verify
    return {"raised": raised, "latest": (ckpt / "latest").exists()}


# ---------------------------------------------------------------------------
# sequence parallelism: the ring and Ulysses over a sequence line, and
# GPT-2 trained at a sequence axis of 2 (the ranks of a line feed the
# same rows, their data rank's; the engine keeps each rank's tokens)
# ---------------------------------------------------------------------------
SP_DROP = dict(b=2, h=2, s=32, d=8, seed=7)
SP_DROP_RATE, SP_DROP_DRAWS = 0.3, 200


def sp_qkv(b=2, h=4, s=64, d=16, seed=0):
    """tests/unit/test_sequence_parallel.py's inputs: q, k, v [b, h, s,
    d] float32 from a numpy seed."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, s, d)).astype(np.float32)
                 for _ in range(3))


def sp_valid(b=2, s=64, seed=1):
    """A key validity vector [b, s] with the first key always valid."""
    rng = np.random.default_rng(seed)
    valid = (rng.random((b, s)) < 0.8).astype(np.int32)
    valid[:, 0] = 1
    return valid


def _sp_mesh(**sizes):
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    from deepspeed_tpu_torch.runtime import dist as dist_lib

    dist_lib.init_distributed(device="cpu")
    return build_mesh(**sizes)


def case_sp_attention(case, rank, world, workdir):
    """The global forms over a sequence axis of the world: outputs (plain,
    causal, padding, fully masked), gradients, the uneven-head dispatch
    and refusal, and the ring's dropout (bits and distribution)."""
    import torch

    import deepspeed_tpu_torch.parallel as P
    from deepspeed_tpu_torch.ops.attention import mha_reference

    mesh = _sp_mesh(sequence_parallel_size=world)
    q, k, v = (torch.from_numpy(x) for x in sp_qkv())
    out = {}
    for name, fn in (("ring", P.ring_attention),
                     ("ulysses", P.ulysses_attention)):
        for causal in (False, True):
            out[f"{name}-causal{int(causal)}"] = fn(
                q, k, v, mesh, causal=causal).numpy()
        out[f"{name}-padding"] = fn(q, k, v, mesh,
                                    torch.from_numpy(sp_valid())).numpy()
        qs, ks, vs = (torch.from_numpy(x).requires_grad_()
                      for x in sp_qkv(s=32))
        (fn(qs, ks, vs, mesh, causal=True) ** 2).sum().backward()
        out[f"{name}-grads"] = [x.grad.numpy() for x in (qs, ks, vs)]
    out["ring-masked"] = P.ring_attention(
        q, k, v, mesh, torch.zeros(2, 64, dtype=torch.int32)).numpy()
    q3, k3, v3 = (torch.from_numpy(x) for x in sp_qkv(h=3))
    out["auto-uneven"] = P.sequence_parallel_attention(
        q3, k3, v3, mesh, causal=True).numpy()
    try:
        P.ulysses_attention(q3, k3, v3, mesh)
        out["uneven-refused"] = None
    except ValueError as e:
        out["uneven-refused"] = str(e)
    qd, kd, vd = (torch.from_numpy(x) for x in sp_qkv(**SP_DROP))

    def ring(seed):
        return P.ring_attention(qd, kd, vd, mesh, dropout_rate=SP_DROP_RATE,
                                dropout_seed=seed)

    first = ring(7)
    out["drop-repeats"] = bool(torch.equal(first, ring(7)))
    out["drop-seed-matters"] = not torch.allclose(first, ring(8))
    out["drop-vs-one-device"] = not torch.allclose(first, mha_reference(
        qd, kd, vd, dropout_rate=SP_DROP_RATE, dropout_seed=7), atol=1e-6)
    draws = np.stack([ring(i).numpy() for i in range(SP_DROP_DRAWS)])
    out["drop-mean"], out["drop-std"] = draws.mean(0), draws.std(0)
    out["drop-clean"] = P.ring_attention(qd, kd, vd, mesh).numpy()
    return out


def case_sp_auto_mp(case, rank, world, workdir):
    """At sequence 2 x model 2, H = 6 gives each model rank 3 heads: auto
    must pick the ring (3 % 2), on this rank's heads of the sequence."""
    import torch

    import deepspeed_tpu_torch.parallel as P
    from deepspeed_tpu_torch.parallel.sequence import choose_impl

    mesh = _sp_mesh(sequence_parallel_size=2, model_parallel_size=2)
    heads = 6 // mesh.mp_size
    lo = mesh.model_rank * heads
    q, k, v = (torch.from_numpy(x[:, lo:lo + heads]) for x in sp_qkv(h=6))
    return {"model_rank": mesh.model_rank, "impl": choose_impl(heads, 2),
            "out": P.sequence_parallel_attention(q, k, v, mesh,
                                                 causal=True).numpy()}


def sp_engine(case, world, workdir):
    """The case's model (GPT-2, BERT or the MLP) at its sequence axis (and
    model axis, with GPT-2's partition_specs, and pipe axis), its data
    size the rest of the world."""
    import deepspeed_tpu_torch as dst

    import torch

    model = _model(case, workdir)
    if case.get("impl"):
        model.layer_config.seq_parallel_impl = case["impl"]
    sp, mp, pp = case["sp"], case.get("mp", 1), case.get("pp", 1)
    extra = dict(case.get("extra", {}))
    extra["mesh"] = {"sequence_parallel_size": sp, "model_parallel_size": mp,
                     "pipeline_parallel_size": pp}
    state = case.get("model_parameters")
    engine, *_ = dst.initialize(
        model=model, device="cpu",
        model_parameters=(None if state is None else torch.load(
            workdir / state, weights_only=True)),
        param_specs=dst.partition_specs(model) if mp > 1 else None,
        config_params=config(case.get("stage", 0), case.get("opt", "Adam"),
                             case.get("dtype", "fp32"), case["micro"],
                             case["accum"], world // (sp * mp * pp),
                             lr=case.get("lr", 1e-2), **extra))
    return engine


def case_sp_train(case, rank, world, workdir):
    """Train the case's windows on this rank's data rows (its sequence
    chunk kept by the engine); rank 0 returns the whole parameters; with
    ``save`` a checkpoint of the last state."""
    engine = sp_engine(case, world, workdir)
    out = {"losses": _feed(engine, case, engine.data_rank,
                           engine.dp_world_size),
           "skipped": engine.skipped_steps,
           "coords": (engine.data_rank, engine.seq_rank, engine.model_rank)}
    full = engine.full_parameters()
    if rank == 0:
        out["params"] = {n: p.detach().float().numpy().copy()
                         for n, p in full.items()}
    if case.get("save"):
        engine.save_checkpoint(str(workdir / case["save"]), tag="sp")
    return out


def case_sp_refusals(case, rank, world, workdir):
    """What a sequence axis above 1 refuses, each by its message."""
    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.ops.transformer import (
        DeepSpeedTransformerConfig,
        DeepSpeedTransformerLayer,
        transformer_block_apply,
    )
    from deepspeed_tpu_torch.parallel.sequence import sequence_line

    out = {}
    base = dict(case, model="gpt2", micro=2, accum=1, sp=world)
    for name, extra in case["engine"].items():
        try:
            sp_engine(dict(base, extra=extra), world, workdir)
            out[name] = None
        except Exception as e:
            out[name] = f"{type(e).__name__}: {e}"
    try:
        sp_engine(dict(base, model="bert", bert=case["bert"]), world,
                  workdir)
        out["bert"] = None
    except Exception as e:
        out["bert"] = f"{type(e).__name__}: {e}"
    line = sequence_line(_sp_mesh(sequence_parallel_size=world))
    cfg = DeepSpeedTransformerConfig(hidden_size=32, heads=4,
                                     attn_dropout_ratio=0.0,
                                     hidden_dropout_ratio=0.0)
    cfg.sequence_parallel = line
    layer = DeepSpeedTransformerLayer(cfg, device="cpu")
    layer.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.zeros(2, 8, 32)
    for name, kw in (("return_kv", dict(return_kv=True)),
                     ("query_mask", dict(attention_mask=torch.zeros(
                         2, 1, 8, 8)))):
        try:
            transformer_block_apply(cfg, layer, x, kw.pop(
                "attention_mask", None), causal=True, **kw)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    piped = dst.GPT2LMHeadModel(dst.GPT2Config(
        vocab_size=VOCAB, n_positions=SEQ, n_embd=32, n_layer=2, n_head=4,
        pipeline_stages=2), device="cpu")
    try:
        piped.configure_sequence_parallel(line)
        out["pipeline"] = None
    except ValueError as e:
        out["pipeline"] = str(e)
    return out



# ---------------------------------------------------------------------------
# serving over the model axis: every rank builds the engine, rank 0 (the
# leader) drives the case's traffic, the others follow its plans
# ---------------------------------------------------------------------------
SERVE_VOCAB = 128
SERVE_BASE = {"max_batch_slots": 4, "max_seq_len": 48, "prefill_len": 32,
              "kv_block_size": 8, "sampling": {"greedy": True}}
SERVE_ADAPTERS = {"enabled": True, "rank": 2, "pool_slots": 4}
#: traffic kind -> the engine's config (the JAX engine takes it too)
SERVE_CONFIGS = {
    "paged": {"inference": dict(SERVE_BASE, fused_decode=True)},
    "prefix": {"inference": dict(SERVE_BASE, fused_decode=True)},
    "contig": {"inference": {k: v for k, v in SERVE_BASE.items()
                             if k != "kv_block_size"}},
    "lora": {"inference": dict(SERVE_BASE, fused_decode=True),
             "adapters": SERVE_ADAPTERS},
    "tier": {"inference": dict(SERVE_BASE, kv_pool_blocks=4,
                               max_batch_slots=2, host_tier={
                                   "enabled": True, "share_group": "mp"})},
    "tier_lora": {"inference": dict(SERVE_BASE, max_batch_slots=2,
                                    host_tier={"enabled": True,
                                               "share_group": "mpa"}),
                  "adapters": dict(SERVE_ADAPTERS, pool_slots=2)},
    "spec": {"inference": dict(SERVE_BASE, speculative={"k": 3})},
    "deadline": {"inference": dict(SERVE_BASE, fused_decode=True)},
}
#: the metrics each traffic kind compares (where the engine has them)
SERVE_COUNTERS = ("infer/prefix_hits", "infer/prefix_misses",
                  "infer/spec_proposed", "infer/spec_accepted",
                  "host_tier/spills", "host_tier/promotions",
                  "host_tier/peer_fetches", "host_tier/preemptions",
                  "adapters/loads", "adapters/evictions")


def serve_prompts(n=3, seed=1, lengths=(8, 11, 5)):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, SERVE_VOCAB, m)]
            for m in lengths[:n]]


def serve_traffic(engine, kind, adapters=None):
    """Drive ``kind``'s traffic through ``engine`` (the port's leader or
    the JAX engine, the same API): its greedy tokens (and, for the tier,
    the engine's pool and tier counters)."""
    ps = serve_prompts()
    if kind in ("paged", "contig", "spec"):
        return engine.generate(ps, max_new_tokens=8)
    if kind == "prefix":
        tmpl = serve_prompts(1, seed=3, lengths=(16,))[0]
        return (engine.generate([tmpl + [1, 2, 3]], max_new_tokens=6)
                + engine.generate([tmpl + [4, 5]], max_new_tokens=6))
    if kind == "lora":
        for name, state in adapters.items():
            engine.load_adapter(name, adapter_state=state)
        reqs = [engine.submit(ps[0], max_new_tokens=6, adapter="b"),
                engine.submit(ps[1], max_new_tokens=6),
                engine.submit(ps[2], max_new_tokens=6, adapter="a")]
        engine.scheduler.run_until_idle()
        return [r.result() for r in reqs]
    if kind == "tier":
        rng = np.random.default_rng(5)
        tmpl = [int(t) for t in rng.integers(0, SERVE_VOCAB, 16)]
        out = engine.generate([tmpl + [1, 2]], max_new_tokens=4)
        for _ in range(2):
            out += engine.generate(
                [[int(t) for t in rng.integers(0, SERVE_VOCAB, 20)]],
                max_new_tokens=4)
        out += engine.generate([tmpl + [3, 4]], max_new_tokens=4)
        snap = engine.kv_snapshot()
        return out, {k: snap[k] for k in (
            "prefix_hits", "host_tier_spills", "host_tier_promotions",
            "host_tier_entries", "host_tier_occupancy_bytes")}
    if kind == "tier_lora":
        # a, b loaded; b served, a touched (b the LRU), c loaded (b
        # evicted and parked), b served again (auto-loaded from the tier)
        for name in ("a", "b"):
            engine.load_adapter(name, adapter_state=adapters[name])
        out = engine.generate([ps[0]], max_new_tokens=6, adapter="b")
        out += engine.generate([ps[1]], max_new_tokens=6, adapter="a")
        engine.load_adapter("c", adapter_state=adapters["c"])
        out += engine.generate([ps[0]], max_new_tokens=6, adapter="b")
        return out
    raise ValueError(kind)


def serve_model(workdir, name="serve.pt", n_layer=2):
    import torch

    import deepspeed_tpu_torch as dst

    m = dst.GPT2LMHeadModel(dst.GPT2Config(
        vocab_size=SERVE_VOCAB, n_positions=64, n_embd=32, n_layer=n_layer,
        n_head=4, dropout=0.0), device="cpu")
    m.load_state_dict(torch.load(workdir / name, weights_only=True))
    return m


def case_serve_mp(case, rank, world, workdir):
    """One engine over a model axis of the world (or the case's ``mesh``
    block: data replicas too): the leader's tokens and counters, every
    rank's local shapes, mesh coordinates and KV pool bytes; ``deadline``
    slows the leader's decode steps until a request's deadline expires
    mid-run."""
    import time

    import torch

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference.decode import gpt2_prefill

    kind = case["traffic"]
    cfg = dict(SERVE_CONFIGS[kind],
               mesh=case.get("mesh", {"model_parallel_size": world}))
    draft = {}
    if kind == "spec":
        draft = dict(draft_model=serve_model(workdir, "draft.pt", 1))
    engine = dst.init_inference(model=serve_model(workdir), config=cfg,
                                device="cpu", **draft)
    out = {"kv_shape": tuple(engine._cache.k.shape),
           "kv_bytes": sum(t.numel() * t.element_size()
                           for t in (engine._cache.k, engine._cache.v)),
           "coords": (engine.rank, engine.mesh.data_rank,
                      engine.mesh.model_rank, engine.is_leader),
           "fused": engine.fused_decode,
           "adapter_shapes": {t: (tuple(a.shape), tuple(b.shape)) for t, (
               a, b) in (engine._adapter_pool or {}).items()}}
    if kind == "paged":
        # the logits of a prompt, every rank calling the collective prefill
        ids = torch.tensor([serve_prompts(1, seed=9, lengths=(12,))[0]])
        out["logits"] = gpt2_prefill(engine.model, ids)[0].numpy()
    if not engine.is_leader:
        engine.serve_forever()
        return out
    adapters = None
    if kind in ("lora", "tier_lora"):
        adapters = {n: torch.load(workdir / f"adapter_{n}.pt",
                                  weights_only=True) for n in "abc"}
    if kind == "deadline":
        decode = engine.decode_tokens

        def slow(active):
            time.sleep(0.05)
            return decode(active)

        engine.decode_tokens = slow
        late = engine.submit(serve_prompts(1)[0], max_new_tokens=38,
                             deadline_secs=0.6)
        engine.scheduler.run_until_idle()
        out["late"] = (late.finish_reason, len(late.result()))
        engine.decode_tokens = decode
        out["tokens"] = serve_traffic(engine, "paged")
    else:
        out["tokens"] = serve_traffic(engine, kind, adapters)
    snap = engine.metrics.snapshot()
    out["counters"] = {k: snap.get(k) for k in SERVE_COUNTERS}
    out["fused_gauge"] = snap["infer/fused_decode"]
    engine.close()
    return out


# ---------------------------------------------------------------------------
# MoE experts over the data axis, and the pipe axis
# ---------------------------------------------------------------------------
MOE_VOCAB = 128


def moe_pp_model(case, workdir):
    """The small GPT-2 of the MoE and pipeline cases (vocab 128, width 64,
    4 heads) with the case's ``experts`` / ``pp`` / ``n_layer`` /
    ``n_micro`` / ``dropout`` / ``remat``, its weights from ``workdir /
    case["weights"]`` (whole: the engine cuts them)."""
    import torch

    import deepspeed_tpu_torch as dst

    m = dst.GPT2LMHeadModel(dst.GPT2Config(
        vocab_size=MOE_VOCAB, n_positions=SEQ, n_embd=64,
        n_layer=case.get("n_layer", 2), n_head=4,
        dropout=case.get("dropout", 0.0),
        moe_experts=case.get("experts", 0),
        pipeline_stages=case.get("pp", 1),
        pipeline_microbatches=case.get("n_micro", 0),
        remat=case.get("remat", False)), device="cpu")
    if case.get("weights"):
        m.load_state_dict(torch.load(workdir / case["weights"],
                                     weights_only=True))
    return m


def moe_pp_engine(case, world, workdir, **over):
    """The case's engine: a pipe axis of ``pp`` and the mesh of the case's
    ``extra`` (the data axis the rest of the world; at a model axis above 1
    the model's Megatron ``partition_specs``)."""
    import deepspeed_tpu_torch as dst

    pp = case.get("pp", 1)
    extra = dict(case.get("extra", {}))
    extra.update(over)
    extra["mesh"] = dict({"pipeline_parallel_size": pp},
                         **extra.get("mesh", {}))
    mesh = extra["mesh"]
    dp = world // (mesh.get("pipeline_parallel_size", 1)
                   * mesh.get("model_parallel_size", 1)
                   * mesh.get("sequence_parallel_size", 1))
    model = moe_pp_model(case, workdir)
    engine, *_ = dst.initialize(
        model=model, device="cpu", rng_seed=case.get("rng_seed", 0),
        optimizer=(dst.Adam(state_dtype="int8") if case.get("client_int8")
                   else None),
        param_specs=(dst.partition_specs(model)
                     if mesh.get("model_parallel_size", 1) > 1 else None),
        config_params=config(case.get("stage", 0), case.get("opt", "Adam"),
                             case.get("dtype", "fp32"), case["micro"],
                             case.get("accum", 1), dp,
                             lr=case.get("lr", 1e-4), **extra))
    return engine


def _moe_pp_windows(case, dp):
    return windows("gpt2", case["steps"], case.get("accum", 1),
                   case["micro"] * dp, case.get("data_seed", 0),
                   vocab=MOE_VOCAB)


def _moe_pp_run(engine, win):
    import torch

    dp, d = engine.dp_world_size, engine.data_rank
    rows = [tuple(torch.from_numpy(x) for x in rank_rows(b, d, dp))
            for b in win]
    return float(engine.train_batch(iter(rows)))


def case_moe_pp_train(case, rank, world, workdir):
    """Train the case's windows; rank 0 returns the whole (expert- and
    stage-gathered) parameters; every rank its losses, ``last_aux`` and
    the names and shapes it holds (with ``held``, :func:`held_state`)."""
    engine = moe_pp_engine(case, world, workdir)
    losses = [_moe_pp_run(engine, w)
              for w in _moe_pp_windows(case, engine.dp_world_size)]
    out = {"losses": losses, "skipped": engine.skipped_steps,
           "aux": [a.numpy().copy() for a in engine.last_aux],
           "coeffs": [float(c) for c in engine.lamb_coeffs],
           "local_shapes": {n: tuple(p.shape)
                            for n, p in engine.module.named_parameters()},
           "coords": (engine.pipe_rank, engine.data_rank),
           "plan": getattr(engine.module, "last_pipeline_plan", None)}
    full = engine.full_parameters()
    if rank == 0:
        out["params"] = {n: p.detach().float().numpy().copy()
                         for n, p in full.items()}
    if getattr(engine.optimizer_obj, "state_dtype", "fp32") == "int8":
        out["int8"] = int8_state(engine)
    if case.get("held"):
        out["held"] = held_state(engine, _moe_pp_windows(
            case, engine.dp_world_size)[0][0])
    return out


def held_state(engine, batch):
    """What an int8 rank holds: its ZeRO stage; each int8 first-moment
    group's element count; the model elements whose optimizer state it
    steps (a flat ZeRO leaf's real ones, its padding left out) beside
    those of its trainable tensors, stage 0's count; its module's
    parameter elements and the masters' that are not the module's
    tensors; and, after one more micro-step's backward on the global
    ``batch``, the gradient buffer's elements beside its optimizer
    leaves'."""
    import math

    import torch

    zero = engine._zero
    shapes = (zero.shapes if zero is not None else
              {n: tuple(p.shape) for n, p in engine.params.items()})
    whole = sum(math.prod(s) for s in shapes.values())
    stepped = whole
    if zero is not None and zero.sharded:
        stepped = 0
        for leaf in zero.leaves.values():
            if leaf.runs is not None:
                stepped += sum(n for *_, n in leaf.runs.segments)
            elif leaf.flat:
                total = sum(math.prod(s) for _, s in leaf.members)
                stepped += max(0, min(leaf.numel,
                                      total - zero.rank * leaf.numel))
            else:
                stepped += leaf.numel
    module = {p.untyped_storage().data_ptr()
              for p in engine.module.parameters()}
    rows = rank_rows(batch, engine.data_rank, engine.dp_world_size)
    ids, labels = (torch.from_numpy(x) for x in rows)
    engine.backward(engine(ids, labels))
    grads = sum(g.numel() for g in engine._grad_buffer.values())
    engine.zero_grad()
    return {"zero_stage": engine.zero_stage,
            "mu": {g: int(leaf["q"].numel())
                   for g, leaf in engine.optimizer_state["mu"].items()},
            "stepped": stepped, "whole": whole,
            "module": sum(p.numel() for p in engine.module.parameters()),
            "masters": sum(p.numel() for p in engine.params.values()
                           if p.untyped_storage().data_ptr() not in module),
            "grads": grads,
            "leaves": (sum(lf.numel for lf in zero.leaves.values())
                       if zero is not None else whole)}


def int8_state(engine):
    """The engine's int8 first moment as the whole JAX leaves, keyed by
    group (a collective: a pipeline stage's, a data rank's experts' and a
    ZeRO rank's parts joined), numpy ``{"q", "scale"}`` each."""
    from deepspeed_tpu_torch.runtime import checkpointing

    mu = checkpointing.whole_int8_moments(
        engine, checkpointing._host_tree(engine.optimizer_state["mu"]))
    return {g: {k: v.numpy().copy() for k, v in leaf.items()}
            for g, leaf in mu.items()}


def moe_pp_fingerprint(engine):
    """The eval loss of a fixed global batch of 4 rows, averaged over the
    data group (every stage returns the same)."""
    import torch
    import torch.distributed as dist

    dp, d = engine.dp_world_size, engine.data_rank
    ids = windows("gpt2", 1, 1, 4, seed=99, vocab=MOE_VOCAB)[0][0][0]
    per = 4 // dp
    mine = torch.from_numpy(ids[d * per:(d + 1) * per]).long()
    engine.eval()
    loss = engine(mine, mine).detach().clone()
    engine.train()
    if dp > 1:
        dist.all_reduce(loss, group=engine._dp_group)
    return float(loss) / dp


def case_moe_pp_checkpoint(case, rank, world, workdir):
    """``save``: 2 windows then a save to ``dir``; ``load``: load it.
    Either way the eval fingerprint and 2 more windows follow (the second
    reads the restored optimizer state)."""
    engine = moe_pp_engine(case, world, workdir,
                           resilience={"enabled": True})
    data = windows("gpt2", 4, 1, case["micro"] * engine.dp_world_size, 0,
                   vocab=MOE_VOCAB)
    ckpt = Path(case["dir"])
    out = {}
    if case["mode"] == "save":
        out["train"] = [_moe_pp_run(engine, w) for w in data[:2]]
        engine.save_checkpoint(str(ckpt), tag="t2")
        out["files"] = sorted(os.listdir(ckpt / "t2"))
    else:
        path, _ = engine.load_checkpoint(str(ckpt))
        out["loaded"] = path is not None
        out["global_steps"] = engine.global_steps
    out["fingerprint"] = moe_pp_fingerprint(engine)
    out["resume"] = [_moe_pp_run(engine, w) for w in data[2:]]
    return out


def case_moe_pp_refusals(case, rank, world, workdir):
    """Each of the case's ``refusals`` ({name: engine config changes}):
    the message the engine raised, or None."""
    out = {}
    for name, over in case["refusals"].items():
        sub = dict(case, **over.pop("case", {}))
        try:
            moe_pp_engine(sub, world, workdir, **over)
            out[name] = None
        except Exception as exc:  # the message is the result
            out[name] = f"{type(exc).__name__}: {exc}"
    return out


def toy_pipeline(n_stages=2, per_stage=3, n_micro=4, mb=2, s=8, h=16):
    """tests/unit/test_pipeline.py's toy: W [L, h, h], X [M, mb, s, h]."""
    rng = np.random.default_rng(0)
    W = (rng.normal(size=(n_stages * per_stage, h, h)) * 0.2
         ).astype(np.float32)
    X = rng.normal(size=(n_micro, mb, s, h)).astype(np.float32)
    return W, X


def case_pp_gpipe(case, rank, world, workdir):
    """The GPipe schedule on the toy stage (``tanh(x @ w)``, 3 layers a
    stage) over a pipe line of the world: outputs and the gradients of
    ``sum(out ** 2)`` (this stage's weights, the inputs on stage 0), the
    per-microbatch scalars of a ``last_stage_fn`` and their gradients,
    and an exp-amplifying stage's finiteness."""
    import torch

    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    from deepspeed_tpu_torch.parallel.pipeline import gpipe, pipeline_line
    from deepspeed_tpu_torch.runtime import dist as dist_lib

    dist_lib.init_distributed(True)
    line = pipeline_line(build_mesh(pipeline_parallel_size=world))
    W, X = toy_pipeline(n_stages=world)
    per = W.shape[0] // world
    out = {}

    def tanh_stage(w, x, m, extras):
        for i in range(w.shape[0]):
            x = torch.tanh(x @ w[i])
        return x

    def exp_stage(w, x, m, extras):
        for i in range(w.shape[0]):
            x = torch.exp(torch.clamp(x @ w[i], -50.0, 50.0)) * 1e-2
        return x

    def head(y, m, extras):
        return torch.mean(y * y) + 0.5 * m

    for name, fn, last in (("plain", tanh_stage, None),
                           ("head", tanh_stage, head),
                           ("exp", exp_stage, None)):
        w = torch.from_numpy(W[rank * per:(rank + 1) * per]).requires_grad_()
        x = torch.from_numpy(X).requires_grad_()
        y = gpipe(fn, w, x, line, last_stage_fn=last)
        loss = torch.sum(y) if last is not None else torch.sum(y ** 2)
        loss.backward()
        out[name] = {"out": y.detach().numpy().copy(),
                     "loss": float(loss),
                     "grad_w": w.grad.numpy().copy(),
                     "grad_x": (x.grad.numpy().copy() if x.grad is not None
                                else None)}
    return out


CASES = {
    "mp_train": case_mp_train, "mp_checkpoint": case_mp_checkpoint,
    "mp_dropout": case_mp_dropout, "mp_pieces": case_mp_pieces,
    "mp_preempt": case_mp_preempt, "mp_load_disagree": case_mp_load_disagree,
    "mp_commit_fail": case_mp_commit_fail,
    "train": case_train, "overflow": case_overflow, "dropout": case_dropout,
    "bert": case_bert, "checkpoint": case_checkpoint, "dist": case_dist,
    "sparse": case_sparse, "gather_order": case_gather_order,
    "preempt": case_preempt, "load_disagree": case_load_disagree,
    "commit_fail": case_commit_fail,
    "sp_attention": case_sp_attention, "sp_auto_mp": case_sp_auto_mp,
    "sp_train": case_sp_train, "sp_refusals": case_sp_refusals,
    "serve_mp": case_serve_mp,
    "moe_pp_train": case_moe_pp_train,
    "moe_pp_checkpoint": case_moe_pp_checkpoint,
    "moe_pp_refusals": case_moe_pp_refusals,
    "pp_gpipe": case_pp_gpipe,
}


def main(spec_path):
    import torch

    torch.set_num_threads(1)
    spec = json.loads(Path(spec_path).read_text())
    workdir = Path(spec["workdir"])
    rank = int(os.environ["DS_TPU_PROCESS_ID"])
    dp = int(os.environ["DS_TPU_NUM_PROCESSES"])
    results = {}
    for case in spec["cases"]:
        results[case["name"]] = CASES[case["kind"]](case, rank, dp, workdir)
    torch.save(results, workdir / f"rank{rank}.pt")
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the test process's side
# ---------------------------------------------------------------------------
def free_port():
    """A free local port (for a launcher that takes ``--master_port``)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start(world, cases, workdir):
    """Start ``world`` rank processes running ``cases``; returns a handle
    for :func:`finish` (the caller can compute meanwhile).

    The rendezvous store is this process's: a ``TCPStore`` listening on a
    port the kernel picks, held until :func:`finish`, and every rank
    joins it as a client (torch.distributed's agent-store mode, as under
    an elastic agent). No port is chosen, released and bound again, so
    no other spawn, in this process or another, can take it between."""
    import torch.distributed as dist

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    spec = workdir / "spec.json"
    spec.write_text(json.dumps({"workdir": str(workdir), "cases": cases}))
    store = dist.TCPStore("localhost", 0, world, is_master=True,
                          wait_for_workers=False)
    procs = []
    for rank in range(world):
        env = dict(os.environ,
                   DS_TPU_COORDINATOR_ADDRESS=f"localhost:{store.port}",
                   DS_TPU_NUM_PROCESSES=str(world),
                   DS_TPU_PROCESS_ID=str(rank),
                   TORCHELASTIC_USE_AGENT_STORE="True",
                   TORCHELASTIC_RESTART_COUNT="0",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT), os.environ.get("PYTHONPATH", "")]),
                   OMP_NUM_THREADS="1")
        log = open(workdir / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, str(spec)], env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    return world, workdir, procs, store


def finish(handle, timeout=120):
    """Wait for the ranks (killing them all past ``timeout`` seconds);
    returns ``[rank 0's results, rank 1's, ...]`` or raises with the
    logs of the ranks that failed."""
    world, workdir, procs, _ = handle  # the store lives as long
    deadline = time.monotonic() + timeout
    failed, timed_out = [], False
    for rank, (proc, log) in enumerate(procs):
        try:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            timed_out = True
            for p, _ in procs:
                p.kill()
            proc.wait()
        log.close()
        if proc.returncode != 0:
            failed.append(rank)
    if failed:
        logs = "\n".join(
            f"--- rank {r} ---\n"
            + (workdir / f"rank{r}.log").read_text()[-4000:] for r in failed)
        what = (f"timed out after {timeout} s (all killed)" if timed_out
                else "failed")
        raise RuntimeError(f"ranks {failed} {what}:\n{logs}")
    import torch

    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main(sys.argv[1])

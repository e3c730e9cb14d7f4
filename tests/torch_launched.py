"""A user script for the port's launcher tests (not a test module).

The tests start it through ``python -m deepspeed_tpu_torch.launcher.runner``
as a user would start a training script: it parses its arguments with
``add_config_arguments`` and reads its rank from the environment the
launcher exports. ``--mode``:

- ``train``: ``initialize(args=...)`` on the 2-layer GPT-2 of
  tests/torch_dp_gpt2.py (weights from ``--workdir``/gpt2.pt), this
  rank's rows of the windows of tests/torch_dp_ranks.py; saves the
  losses, the final parameters (rank 0) and the launcher's variables to
  ``rank<RANK>.pt``.
- ``fail``: rank 0 writes ``started`` and sleeps (a rank blocked on a
  peer that is gone); rank 1 exits 3 as soon as rank 0 has started.
- ``preempt``: an MLP engine with the preemption drain trains window
  after window; each rank writes ``ready<RANK>`` after its first window.
  A SIGTERM then drains every rank into one checkpoint under
  ``--workdir``/ckpt, and the ranks exit through the signal.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import torch  # noqa: E402

import deepspeed_tpu_torch as dst  # noqa: E402
import torch_dp_ranks as ranks  # noqa: E402

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "CUDA_VISIBLE_DEVICES",
       "DS_TPU_PROCESS_ID", "DS_TPU_NUM_PROCESSES", "MASTER_ADDR",
       "MASTER_PORT", "DS_TPU_COORDINATOR_ADDRESS")


def parse():
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", required=True)
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--steps", type=int, default=5)
    return dst.add_config_arguments(parser).parse_args()


def train(args, rank, dp, workdir):
    import torch.distributed as dist

    model = ranks._model({"model": "gpt2", "weights": "gpt2.pt"}, workdir)
    engine, *_ = dst.initialize(args=args, model=model, device="cpu")
    cfg = json.loads(Path(args.deepspeed_config).read_text())
    micro = cfg["train_micro_batch_size_per_gpu"]
    accum = cfg["gradient_accumulation_steps"]
    losses = []
    for win in ranks.windows("gpt2", args.steps, accum, micro * dp):
        mine = [tuple(torch.from_numpy(x) for x in ranks.rank_rows(b, rank,
                                                                   dp))
                for b in win]
        losses.append(float(engine.train_batch(iter(mine))))
    out = {"losses": losses, "env": {k: os.environ.get(k) for k in ENV},
           "backend": dist.get_backend(), "world": dist.get_world_size(),
           "rank": dist.get_rank()}
    full = engine.full_parameters()
    if rank == 0:
        out["params"] = {n: p.detach().float().numpy().copy()
                         for n, p in full.items()}
    torch.save(out, workdir / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def fail(rank, workdir):
    if rank == 1:
        # exit once rank 0 runs: the two start together, and a rank 0
        # still importing when rank 1 exits would be ended before it
        # could show that it ran
        deadline = time.monotonic() + 60
        while (not (workdir / "started").exists()
               and time.monotonic() < deadline):
            time.sleep(0.05)
        sys.exit(3)
    (workdir / "started").write_text("0")
    time.sleep(120)


def preempt(rank, dp, workdir):
    engine, *_ = dst.initialize(
        model=ranks.torch_mlp(ranks.mlp_weights()), device="cpu",
        config_params=ranks.config(
            1, "Adam", "fp32", 2, 1, dp, resilience={
                "enabled": True, "preemption": {
                    "enabled": True, "save_dir": str(workdir / "ckpt")}}))
    for step in range(2000):  # bounded: a lost signal must not run forever
        batch = ranks.windows("mlp", 1, 1, 2 * dp, step)[0][0]
        mine = tuple(torch.from_numpy(x)
                     for x in ranks.rank_rows(batch, rank, dp))
        engine.train_batch(iter([mine]))
        if step == 0:
            (workdir / f"ready{rank}").write_text("1")
    sys.exit(5)


def main():
    args = parse()
    torch.set_num_threads(1)
    workdir = Path(args.workdir)
    rank = int(os.environ["RANK"])
    dp = int(os.environ["WORLD_SIZE"])
    if args.mode == "train":
        train(args, rank, dp, workdir)
    elif args.mode == "fail":
        fail(rank, workdir)
    else:
        preempt(rank, dp, workdir)


if __name__ == "__main__":
    main()

"""LR schedules: LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR.

A copy of deepspeed_tpu/runtime/lr_schedules.py, which holds no JAX (the
port imports nothing of the JAX package, so it keeps its own copy): the
reference's schedules with the ``.step()/.get_lr()/.state_dict()/
.load_state_dict()`` surface, OneCycle's ``get_mom()``, and the CLI
tuning-argument plumbing. Schedules compute values (floats) that the
engine hands to the optimizer each step.
"""

import argparse
import math

LR_SCHEDULE = "lr_schedule"
LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR]

LR_RANGE_TEST_MIN_LR = "lr_range_test_min_lr"
LR_RANGE_TEST_STEP_RATE = "lr_range_test_step_rate"
LR_RANGE_TEST_STEP_SIZE = "lr_range_test_step_size"
LR_RANGE_TEST_STAIRCASE = "lr_range_test_staircase"

CYCLE_FIRST_STEP_SIZE = "cycle_first_step_size"
CYCLE_FIRST_STAIR_COUNT = "cycle_first_stair_count"
CYCLE_SECOND_STEP_SIZE = "cycle_second_step_size"
CYCLE_SECOND_STAIR_COUNT = "cycle_second_stair_count"
DECAY_STEP_SIZE = "decay_step_size"
CYCLE_MIN_LR = "cycle_min_lr"
CYCLE_MAX_LR = "cycle_max_lr"
DECAY_LR_RATE = "decay_lr_rate"
CYCLE_MIN_MOM = "cycle_min_mom"
CYCLE_MAX_MOM = "cycle_max_mom"
DECAY_MOM_RATE = "decay_mom_rate"

WARMUP_MIN_LR = "warmup_min_lr"
WARMUP_MAX_LR = "warmup_max_lr"
WARMUP_NUM_STEPS = "warmup_num_steps"


class _Schedule:
    """Common host-side schedule machinery (step counter + state dict)."""

    def __init__(self, last_batch_iteration=-1):
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self):
        raise NotImplementedError

    def get_last_lr(self):
        return self._last_lr

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        self._last_lr = self.get_lr()
        return self._last_lr

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]
        self._last_lr = self.get_lr()


class LRRangeTest(_Schedule):
    """LR sweep for tuning (reference :298-397): lr = min_lr * (1 + step/size
    * rate) continuously, or staircase per interval."""

    def __init__(
        self,
        lr_range_test_min_lr=1e-3,
        lr_range_test_step_size=2000,
        lr_range_test_step_rate=1.0,
        lr_range_test_staircase=False,
        last_batch_iteration=-1,
        **_,
    ):
        super().__init__(last_batch_iteration)
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase
        self._last_lr = self.get_lr()

    def get_lr(self):
        it = max(0, self.last_batch_iteration)
        if self.staircase:
            count = float(it // self.step_size)
        else:
            count = it / self.step_size
        return self.min_lr * (1.0 + self.step_rate * count)


class OneCycle(_Schedule):
    """Two-phase cyclical LR + optional momentum cycling + tail decay
    (reference :398-641)."""

    def __init__(
        self,
        cycle_min_lr=0.0,
        cycle_max_lr=1e-3,
        decay_lr_rate=0.0,
        cycle_first_step_size=2000,
        cycle_second_step_size=None,
        cycle_first_stair_count=0,
        cycle_second_stair_count=None,
        decay_step_size=0,
        cycle_momentum=True,
        cycle_min_mom=0.8,
        cycle_max_mom=0.9,
        decay_mom_rate=0.0,
        last_batch_iteration=-1,
        **_,
    ):
        super().__init__(last_batch_iteration)
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first_size = cycle_first_step_size
        self.second_size = (
            cycle_second_step_size
            if cycle_second_step_size is not None
            else cycle_first_step_size
        )
        self.total_size = self.first_size + self.second_size
        self.first_stairs = cycle_first_stair_count or 0
        self.second_stairs = (
            cycle_second_stair_count
            if cycle_second_stair_count is not None
            else self.first_stairs
        )
        self.decay_step_size = decay_step_size
        self.cycle_momentum = cycle_momentum
        self.cycle_min_mom = cycle_min_mom
        self.cycle_max_mom = cycle_max_mom
        self.decay_mom_rate = decay_mom_rate
        self._last_lr = self.get_lr()

    @staticmethod
    def _stair(frac, stairs):
        """Quantize a 0..1 fraction into ``stairs`` discrete steps
        (the reference's stair_count staircase behavior)."""
        if stairs and stairs > 0:
            return math.floor(frac * stairs) / stairs
        return frac

    def _cycle_fraction(self, it):
        """Position within the (single) cycle: 0→1 up over phase 1,
        1→0 down over phase 2."""
        if it < self.first_size:
            return self._stair(it / self.first_size, self.first_stairs)
        if it < self.total_size:
            return 1.0 - self._stair(
                (it - self.first_size) / self.second_size, self.second_stairs
            )
        return 0.0

    def get_lr(self):
        it = max(0, self.last_batch_iteration)
        if it < self.total_size:
            frac = self._cycle_fraction(it)
            return self.cycle_min_lr + (self.cycle_max_lr - self.cycle_min_lr) * frac
        # decay tail
        decay_steps = it - self.total_size
        if self.decay_step_size > 0:
            intervals = decay_steps // self.decay_step_size
        else:
            intervals = decay_steps
        return self.cycle_min_lr / (1.0 + self.decay_lr_rate * intervals)

    def get_mom(self):
        if not self.cycle_momentum:
            return None
        it = max(0, self.last_batch_iteration)
        if it < self.total_size:
            frac = self._cycle_fraction(it)
            # momentum cycles inversely to lr
            return self.cycle_max_mom - (self.cycle_max_mom - self.cycle_min_mom) * frac
        decay_steps = it - self.total_size
        if self.decay_step_size > 0:
            intervals = decay_steps // self.decay_step_size
        else:
            intervals = decay_steps
        return self.cycle_max_mom * (1.0 + self.decay_mom_rate * intervals)


class WarmupLR(_Schedule):
    """Log-linear warmup from min to max lr, then constant (reference :642-712)."""

    def __init__(
        self,
        warmup_min_lr=0.0,
        warmup_max_lr=0.001,
        warmup_num_steps=1000,
        last_batch_iteration=-1,
        **_,
    ):
        super().__init__(last_batch_iteration)
        self.min_lr = warmup_min_lr
        self.max_lr = warmup_max_lr
        self.warmup_num_steps = max(1, warmup_num_steps)
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps + 1)
        self._last_lr = self.get_lr()

    def get_lr(self):
        it = max(0, self.last_batch_iteration)
        if it < self.warmup_num_steps:
            gamma = self.inverse_log_warm_up * math.log(it + 1)
            return self.min_lr + (self.max_lr - self.min_lr) * gamma
        return self.max_lr


class WarmupDecayLR(WarmupLR):
    """Warmup then linear decay to zero over total_num_steps (a later-
    reference-version schedule, included for forward compatibility)."""

    def __init__(self, total_num_steps=10000, **kw):
        self.total_num_steps = total_num_steps
        super().__init__(**kw)

    def get_lr(self):
        it = max(0, self.last_batch_iteration)
        if it < self.warmup_num_steps:
            return super().get_lr()
        frac = min(1.0, (it - self.warmup_num_steps)
                   / max(1, self.total_num_steps - self.warmup_num_steps))
        return self.max_lr * (1.0 - frac)


SCHEDULES = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    "WarmupDecayLR": WarmupDecayLR,
}


def build_lr_scheduler(name, params):
    if name not in SCHEDULES:
        raise ValueError(
            f"Unknown lr schedule '{name}'; valid: {sorted(SCHEDULES)}"
        )
    return SCHEDULES[name](**params)


# ---------------------------------------------------------------------------
# CLI plumbing (reference :51-257)
# ---------------------------------------------------------------------------
def add_tuning_arguments(parser=None):
    if parser is None:
        parser = argparse.ArgumentParser()
    group = parser.add_argument_group("Convergence Tuning")
    group.add_argument("--lr_schedule", type=str, default=None)
    group.add_argument("--lr_range_test_min_lr", type=float, default=0.001)
    group.add_argument("--lr_range_test_step_rate", type=float, default=1.0)
    group.add_argument("--lr_range_test_step_size", type=int, default=1000)
    group.add_argument("--lr_range_test_staircase", type=bool, default=False)
    group.add_argument("--cycle_first_step_size", type=int, default=1000)
    group.add_argument("--cycle_first_stair_count", type=int, default=1)
    group.add_argument("--cycle_second_step_size", type=int, default=None)
    group.add_argument("--cycle_second_stair_count", type=int, default=None)
    group.add_argument("--decay_step_size", type=int, default=1000)
    group.add_argument("--cycle_min_lr", type=float, default=0.01)
    group.add_argument("--cycle_max_lr", type=float, default=0.1)
    group.add_argument("--decay_lr_rate", type=float, default=0.0)
    group.add_argument("--cycle_min_mom", type=float, default=0.8)
    group.add_argument("--cycle_max_mom", type=float, default=0.9)
    group.add_argument("--decay_mom_rate", type=float, default=0.0)
    group.add_argument("--warmup_min_lr", type=float, default=0.0)
    group.add_argument("--warmup_max_lr", type=float, default=0.001)
    group.add_argument("--warmup_num_steps", type=int, default=1000)
    return parser


def get_config_from_args(args):
    if not hasattr(args, "lr_schedule") or args.lr_schedule is None:
        return None, "--lr_schedule is not specified"
    if args.lr_schedule not in VALID_LR_SCHEDULES:
        return None, f"{args.lr_schedule} is not a valid lr schedule"
    prefixes = {
        LR_RANGE_TEST: ("lr_range_test_",),
        ONE_CYCLE: ("cycle_", "decay_"),
        WARMUP_LR: ("warmup_",),
    }[args.lr_schedule]
    config = {"type": args.lr_schedule, "params": {}}
    for key, val in vars(args).items():
        if key.startswith(prefixes) and val is not None:
            config["params"][key] = val
    return config, None

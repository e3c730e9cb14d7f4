"""Loss scaling for fp16 training.

Port of deepspeed_tpu/runtime/precision.py: the static scale, the
dynamic scale (start 2**initial_scale_power, x2 after ``scale_window``
overflow-free steps, /2 on overflow floored at ``min_scale``, with
hysteresis absorbing the first overflows) and the identity scaler for
bf16/fp32. The JAX package keeps the state as a pytree updated inside
``jit``; the port's engine steps on the host, so the state is a small
frozen dataclass of Python numbers and ``update_scale`` a pure function
of it with the same schedule.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class LossScaleState:
    loss_scale: float
    good_steps: int = 0  # overflow-free steps since the last change
    hysteresis: int = 1  # remaining overflow tolerance
    scale_window: int = 1000
    scale_factor: float = 2.0
    min_scale: float = 1.0
    delayed_shift: int = 1
    consecutive_hysteresis: bool = False
    dynamic: bool = True


def dynamic_loss_scale_state(init_scale=2.0**32, scale_window=1000,
                             scale_factor=2.0, min_scale=1.0,
                             delayed_shift=1, consecutive_hysteresis=False):
    return LossScaleState(
        loss_scale=float(init_scale), good_steps=0,
        hysteresis=int(delayed_shift), scale_window=scale_window,
        scale_factor=scale_factor, min_scale=min_scale,
        delayed_shift=delayed_shift,
        consecutive_hysteresis=consecutive_hysteresis, dynamic=True,
    )


def static_loss_scale_state(scale):
    return LossScaleState(loss_scale=float(scale), dynamic=False)


def no_loss_scale_state():
    """Identity scaler for bf16/fp32."""
    return static_loss_scale_state(1.0)


def update_scale(state, overflow):
    """The next state after a step with (``overflow``) or without an
    overflow (reference loss_scaler.py:151-166):
      overflow, hysteresis exhausted -> scale = max(scale/factor, min)
      overflow, hysteresis remaining -> hysteresis - 1, scale kept
      scale_window clean steps       -> scale *= factor (and the
                                        hysteresis refilled)"""
    if not state.dynamic:
        return state
    if overflow:
        if state.hysteresis <= 1:
            return dataclasses.replace(
                state, good_steps=0,
                loss_scale=max(state.loss_scale / state.scale_factor,
                               state.min_scale),
            )
        return dataclasses.replace(
            state, good_steps=0, hysteresis=state.hysteresis - 1
        )
    window_done = (state.good_steps + 1) % state.scale_window == 0
    hysteresis = state.hysteresis
    if state.consecutive_hysteresis or window_done:
        hysteresis = state.delayed_shift
    return dataclasses.replace(
        state,
        good_steps=state.good_steps + 1,
        hysteresis=hysteresis,
        loss_scale=(state.loss_scale * state.scale_factor if window_done
                    else state.loss_scale),
    )


def loss_scale_state_from_config(config):
    """The scaler a DeepSpeedConfig asks for."""
    if config.fp16_enabled:
        if config.dynamic_loss_scale:
            return dynamic_loss_scale_state(
                init_scale=2.0**config.initial_scale_power,
                scale_window=config.loss_scale_window,
                min_scale=config.min_loss_scale,
                delayed_shift=config.hysteresis,
            )
        return static_loss_scale_state(config.loss_scale)
    return no_loss_scale_state()

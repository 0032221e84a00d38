"""Learning-rate schedules; port of
``myimagecaptioningmodel_tpu/training/lr_schedules.py`` (reference
tools/util.py:20-119).

Each schedule is a plain function of the integer optimizer step count that
returns a float. The counter-origin quirks are kept: the warmup variants
count steps from 1 (util.py:55,99), the plain restart variant from 0
(util.py:47-51,76).

Strategies (reference get_lr, util.py:20-44):
- None                         constant base_lr
- 'cosine_decay'               Paddle fluid.layers.cosine_decay
- 'cosine_decay_restart'       TF cosine_decay_restarts port (t_mul=2, m_mul=1)
- 'cosine_decay_warmup'        linear warmup then single cosine
- 'cosine_decay_restart_warmup' linear warmup then cosine restarts
"""

from __future__ import annotations

import math
from typing import Callable, Optional

Schedule = Callable[[int], float]


def constant(base_lr: float) -> Schedule:
    return lambda step: float(base_lr)


def cosine_decay(base_lr: float, step_each_epoch: int, epochs: int) -> Schedule:
    """Paddle fluid.layers.cosine_decay: lr * 0.5 * (cos(epoch*pi/epochs) + 1)."""

    def schedule(step):
        cur_epoch = math.floor(step / step_each_epoch)
        return base_lr * 0.5 * (math.cos(cur_epoch * math.pi / epochs) + 1.0)

    return schedule


def cosine_decay_warmup(base_lr: float, step_each_epoch: int, max_epochs: int,
                        warmup_epoch: int, start_lr: float = 0.00001) -> Schedule:
    """Linear warmup over ``warmup_epoch`` epochs, then cosine to 0 (its step
    counter begins at 1)."""
    linear_factor = (base_lr - start_lr) / warmup_epoch

    def schedule(step):
        cur_epoch = math.floor((step + 1) / step_each_epoch)  # counter begins at 1
        if cur_epoch < warmup_epoch:
            return start_lr + linear_factor * cur_epoch
        return 0.5 * base_lr * (math.cos((cur_epoch - warmup_epoch) * math.pi
                                         / float(max_epochs - warmup_epoch)) + 1.0)

    return schedule


def _restart_fraction(completed_fraction: float, t_mul: float):
    """(i_restart, within-restart fraction) per TF cosine_decay_restarts."""
    cf = max(completed_fraction, 0.0)
    if t_mul == 1.0:
        i_restart = math.floor(cf)
        return i_restart, cf - i_restart
    i_restart = math.floor(math.log(1.0 - cf * (1.0 - t_mul)) / math.log(t_mul))
    sum_r = (1.0 - t_mul ** i_restart) / (1.0 - t_mul)
    return i_restart, (cf - sum_r) / t_mul ** i_restart


def cosine_decay_restart(base_lr: float, step_each_epoch: int, decay_epochs: int,
                         m_mul: float = 1.0, t_mul: float = 2.0) -> Schedule:
    """TF cosine_decay_restarts on the epoch index (reference util.py:69-89)."""

    def schedule(step):
        cur_epoch = math.floor(step / step_each_epoch)
        i_restart, cf = _restart_fraction(cur_epoch / decay_epochs, t_mul)
        return base_lr * 0.5 * m_mul ** i_restart * (math.cos(math.pi * cf) + 1.0)

    return schedule


def cosine_decay_restart_warmup(base_lr: float, step_each_epoch: int, decay_epochs: int,
                                warmup_epoch: int, t_mul: float = 2.0,
                                start_lr: float = 0.00001) -> Schedule:
    """Warmup then cosine restarts (reference util.py:92-119); cur_epoch ==
    floor(global_step / step_each_epoch) with the counter starting at 1."""
    linear_step = base_lr - start_lr

    def schedule(step):
        cur_epoch = math.floor((step + 1) / step_each_epoch)
        if cur_epoch < warmup_epoch:
            return start_lr + linear_step * (cur_epoch / float(warmup_epoch))
        _i, cf = _restart_fraction((cur_epoch - warmup_epoch) / decay_epochs, t_mul)
        return base_lr * 0.5 * (math.cos(math.pi * cf) + 1.0)

    return schedule


def get_lr(strategy: Optional[str], base_lr: float, sample_cnt: int, batch_size: int,
           decay_epoch: int = 0, warmup_epoch: int = 3, max_epoch: int = 10) -> Schedule:
    """Strategy dispatch matching reference util.get_lr (util.py:20-44)."""
    valid = (None, "cosine_decay", "cosine_decay_restart", "cosine_decay_restart_warmup",
             "cosine_decay_warmup")
    if strategy not in valid:
        raise ValueError(f"unknown lr decay strategy {strategy!r}")
    step_each_epoch = math.ceil(sample_cnt / batch_size)
    if strategy is None:
        return constant(base_lr)
    if strategy == "cosine_decay":
        return cosine_decay(base_lr, step_each_epoch, decay_epoch)
    if strategy == "cosine_decay_restart":
        return cosine_decay_restart(base_lr, step_each_epoch, decay_epoch)
    if strategy == "cosine_decay_warmup":
        return cosine_decay_warmup(base_lr, step_each_epoch, max_epoch, warmup_epoch)
    return cosine_decay_restart_warmup(base_lr, step_each_epoch, decay_epoch, warmup_epoch)


def from_config(cfg) -> Schedule:
    t = cfg.train
    return get_lr(t.lr_decay_strategy, t.learning_rate, cfg.data.sample_count, t.batch_size,
                  decay_epoch=t.decay_epoch, warmup_epoch=t.warmup_epoch,
                  max_epoch=t.max_epoch)

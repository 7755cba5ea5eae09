"""Host milliseconds per step inside the program's `gpnerf.train.optimizer`
(train/step.py `train_step`: AdamW's step and the schedule's)."""

from benchmark import spans


def read(ctx):
    return spans.step_host_ms(ctx.trace, "gpnerf.train.optimizer")

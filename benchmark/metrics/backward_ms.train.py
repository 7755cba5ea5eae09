"""Host milliseconds per step inside the program's `gpnerf.train.backward`
(train/step.py `forward_backward`: autograd's backward, which the host
waits out, and the zero-gradient fill)."""

from benchmark import spans


def read(ctx):
    return spans.step_host_ms(ctx.trace, "gpnerf.train.backward")

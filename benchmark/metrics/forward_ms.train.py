"""Host milliseconds per step inside the program's `gpnerf.train.forward`
(train/step.py `forward_backward`: zero_grad and `render_train`)."""

from benchmark import spans


def read(ctx):
    return spans.step_host_ms(ctx.trace, "gpnerf.train.forward")

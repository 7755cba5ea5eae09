"""The comparison that decides `correct`: the numbers a run compares with
the reference, each against the limit its configuration file states.

Views: `image_rmse`, the worst over the checked requests of the root mean
square of the image's difference from the reference's, over every pixel,
in [0, 1] color units. It reads every layer up to the image: the encoder,
the volume, the tables, the cull (a ray or a slot the cull loses or adds
changes the image) and the composite.
Training (over the first steps, which set-up drives through the window's
own call):
  * `loss_gap`: the largest |loss - the reference's| / |the reference's|;
  * `grad_gap`: the first gradient as the optimizer holds it after step 1
    (Adam's first moment over 1 - beta1), by the worst leaf: |norm - the
    reference's norm| over the larger of the reference leaf's norm and the
    median leaf's;
  * `change_gap`: the same of each leaf's change over the steps, leaving
    out leaves whose reference gradient is under a thousandth of the
    median leaf's (they move by round-off alone under Adam).
"""

from __future__ import annotations

import statistics

import numpy as np

# leaves whose reference first gradient is under this share of the median
# leaf's are left out of the change
STILL_LEAF = 1e-3


def leaf_norms(named):
    """{leaf name: the float64 norm of its tensor}."""
    return {n: float(t.detach().double().norm()) for n, t in named}


def view_numbers(prog, ref):
    """{number: worst value} over the items `ref` holds; `prog` holds
    each item's image."""
    rmse = 0.0
    for i, r in ref.items():
        d = prog[i].astype(np.float64) - r["image"].astype(np.float64)
        rmse = max(rmse, float(np.sqrt(np.mean(d * d))))
    return {"image_rmse": rmse}


def _leaf_gap(prog, ref, leaves):
    med = statistics.median(ref[n] for n in leaves)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in leaves)


def train_numbers(prog, ref):
    losses = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"])]
    names = sorted(ref["grad1"])
    med = statistics.median(ref["grad1"][n] for n in names)
    moving = [n for n in names if ref["grad1"][n] >= STILL_LEAF * med]
    return {
        "loss_gap": max(losses),
        "grad_gap": _leaf_gap(prog["grad1"], ref["grad1"], names),
        "change_gap": _leaf_gap(prog["change"], ref["change"], moving),
    }


def judge(numbers, limits):
    """(correct, [(name, value, limit)]): every number at or under its
    limit, and none missing."""
    rows = [(k, numbers.get(k), limits[k]) for k in limits]
    ok = all(v is not None and np.isfinite(v) and v <= lim for _, v, lim in rows)
    return bool(ok), rows

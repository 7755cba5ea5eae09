"""Training telemetry: SmoothedValue / MetricLogger.

A copy of gpnerf_tpu/utils/metric_logger.py (reference libs/utils/
misc.py:31-263): windowed medians/averages, iter/data timing, ETA, and
periodic console lines. The port trains on one device, so the
cross-process synchronization hook is a no-op."""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque

import numpy as np


class SmoothedValue:
    """(misc.py:31-90)."""

    def __init__(self, window_size=20, fmt=None):
        if fmt is None:
            fmt = "{median:.4f} ({global_avg:.4f})"
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n=1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median,
            avg=self.avg,
            global_avg=self.global_avg,
            max=self.max,
            value=self.value,
        )


class MetricLogger:
    """(misc.py:163-263)."""

    def __init__(self, delimiter="\t"):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if hasattr(v, "item"):
                v = float(v)
            self.meters[k].update(v)

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def synchronize_between_processes(self):
        pass  # one device: nothing to synchronize

    def __str__(self):
        return self.delimiter.join(
            "{}: {}".format(name, str(meter)) for name, meter in self.meters.items()
        )

    def log_every(self, iterable, print_freq, header="", logger=None):
        i = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        n = len(iterable)
        space_fmt = ":" + str(len(str(n))) + "d"
        log_msg = self.delimiter.join(
            [
                header,
                "[{0" + space_fmt + "}/{1}]",
                "eta: {eta}",
                "{meters}",
                "time: {time}",
                "data: {data}",
            ]
        )
        emit = logger.info if logger is not None else print
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or i == n - 1:
                eta_seconds = iter_time.global_avg * (n - i)
                eta_string = str(datetime.timedelta(seconds=int(eta_seconds)))
                emit(
                    log_msg.format(
                        i, n, eta=eta_string, meters=str(self),
                        time=str(iter_time), data=str(data_time),
                    )
                )
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        total_time_str = str(datetime.timedelta(seconds=int(total_time)))
        emit("{} Total time: {} ({:.4f} s / it)".format(header, total_time_str, total_time / max(n, 1)))

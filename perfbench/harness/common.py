"""Small pieces the traffic generators share."""

from __future__ import annotations

import random
import time

import numpy as np
import torch


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A NumPy generator for one stream of draws from the run's seed."""
    return np.random.default_rng([int(seed) & (2**63 - 1), *stream])


def fit_grid(coords: np.ndarray, n: int):
    """(origin, voxel size) of the grid fitted to `coords`: the box's
    float32 minimum corner, and its longest float32 side over n."""
    c = np.asarray(coords, np.float32).reshape(-1, 3)
    mins, maxs = c.min(axis=0), c.max(axis=0)
    return tuple(float(v) for v in mins), float((maxs - mins).max()) / n


class Sample:
    """A uniform sample of `size` of the units a window completes
    (reservoir sampling), drawn from the run's seed: `offer` each unit's
    answer as it comes, read `kept` once the window has closed."""

    def __init__(self, seed: int, size: int):
        self.size = size
        self.seen = 0
        self.kept: list = []
        self._rng = random.Random(int(seed) * 7919 + 17)

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(item)
            return
        j = self._rng.randrange(self.seen)
        if j < self.size:
            self.kept[j] = item


def limit(traffic: dict, name: str) -> float:
    """The limit of a compared number, from the traffic's `limits`."""
    return float(traffic["limits"][name])


def request_window(seconds: float, rec, tracer, request, sample: Sample) -> None:
    """One client's closed loop: `request(i, rec)` -> (answer, unit), the
    unit a dict with the request's wall time "s" and its "input", until
    `seconds` have passed; each answer is offered to `sample`."""
    tracer.start()
    t_start = time.perf_counter()
    i = 0
    while True:
        answer, unit = request(i, rec)
        rec.units.append(unit)
        sample.offer((unit["input"], answer))
        tracer.unit_done()
        i += 1
        if time.perf_counter() - t_start >= seconds:
            break
    rec.window_s = time.perf_counter() - t_start
    tracer.stop()

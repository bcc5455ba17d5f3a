"""The one traffic generator: it reads a traffic file's parameters and
yields requests, each a list of (mu1, mu2) points of the configuration's
box.

    loop, clients       closed, 1: one client sends its next request when
                        the last one has completed
    points_per_request  mu points in one request (a trajectory each)
    strata              points come in blocks of `strata`, each block a
                        Latin hypercube of the box, so every block covers
                        it evenly and the work a block asks for changes
                        little from seed to seed

The same seed gives the same requests.
"""

from __future__ import annotations

import numpy as np


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def points(cfg: dict, traffic: dict, seed: int):
    """Endless mu points, as the traffic file draws them."""
    rng = _rng(seed, 0)
    lo = np.array([cfg["mu1_range"][0], cfg["mu2_range"][0]])
    hi = np.array([cfg["mu1_range"][1], cfg["mu2_range"][1]])
    n = int(traffic["strata"])
    while True:
        block = np.stack([(rng.permutation(n) + rng.uniform(size=n)) / n
                          for _ in range(2)], axis=1)
        for u in block:
            mu = lo + u * (hi - lo)
            yield float(mu[0]), float(mu[1])


def requests(cfg: dict, traffic: dict, seed: int):
    """Endless requests: lists of `points_per_request` mu points."""
    if traffic["loop"] != "closed" or int(traffic.get("clients", 1)) != 1:
        raise ValueError("only a closed loop of one client is defined")
    it = points(cfg, traffic, seed)
    n = int(traffic["points_per_request"])
    while True:
        yield [next(it) for _ in range(n)]


def check_sample(traffic: dict, seed: int) -> list:
    """Indices of the requests whose answers the check compares: drawn
    from the seed among the first `among_first`; a run that completes
    fewer compares its last one in their place."""
    plan = traffic["check"]
    rng = _rng(seed, 1)
    return sorted(rng.choice(int(plan["among_first"]), size=int(
        plan["sample"]), replace=False).tolist())

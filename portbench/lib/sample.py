"""Samples of a run's answers for the comparison, drawn from the seed."""
from __future__ import annotations

import random


class Reservoir:
    """A uniform sample of ``k`` of the items offered, one pass, drawn from
    ``seed`` (reservoir sampling): only the kept items stay referenced."""

    def __init__(self, k: int, seed: int, tag: str):
        self.k, self.n, self.items = k, 0, []
        self._rng = random.Random(f"{seed}|{tag}")

    def offer(self, key, value) -> None:
        if len(self.items) < self.k:
            self.items.append((key, value))
        else:
            j = self._rng.randrange(self.n + 1)
            if j < self.k:
                self.items[j] = (key, value)
        self.n += 1


def pick(seed: int, tag: str, population: list, k: int) -> list:
    """``k`` of ``population`` (all of it when smaller), drawn from ``seed``."""
    rng = random.Random(f"{seed}|{tag}")
    return population if len(population) <= k else rng.sample(population, k)

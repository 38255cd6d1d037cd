"""The numbers that decide ``correct``, each beside its limit.

A number passes when it is finite and at most its limit; a run is correct
when every number passes and something was compared."""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class Number:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def tail(values, q: float = 0.9) -> float:
    """The ``q`` quantile of ``values`` (linear between order
    statistics)."""
    import torch
    return float(torch.quantile(torch.as_tensor(values).float().cpu(), q))


def spread(errs, gaps) -> str:
    """Quantiles of the judged tokens' logit errors and greedy gaps, for
    the log."""
    import torch
    q = torch.tensor([0.5, 0.9, 0.99, 1.0])
    e = torch.quantile(torch.as_tensor(errs).float().cpu(), q).tolist()
    g = torch.as_tensor(gaps).float().cpu()
    return (f"logit_err p50/p90/p99/max {e}; greedy_gap p50/p90/p99/max "
            f"{torch.quantile(g, q).tolist()}; gaps > 0: "
            f"{int((g > 0).sum())} of {g.numel()}")


def compared(values: dict, limits: dict) -> list:
    """The numbers a cell compares: those its ``limits`` name."""
    return [Number(k, float(v), float(limits[k])) for k, v in values.items()
            if k in limits]


def verdict(numbers: list) -> bool:
    return bool(numbers) and all(n.ok for n in numbers)


def lines(numbers: list) -> list:
    """One plain line a number, for the end of standard error."""
    return [f"check {n.name} {n.value!r} limit {n.limit!r} "
            f"{'ok' if n.ok else 'FAIL'}" for n in numbers]


def as_dict(numbers: list) -> dict:
    return {n.name: {"value": n.value, "limit": n.limit} for n in numbers}

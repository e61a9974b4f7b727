"""The numbers that decide `correct`: gaps between what the program produced
and what the reference computes from the same inputs, each judged against
its own limit (`portbench/limits/<workload>.json`)."""

from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Tuple

import torch

LIMITS = pathlib.Path(__file__).resolve().parent / "limits"


def rel(got, ref) -> float:
    """||got - ref|| / ||ref|| over every element, in float64; infinite
    where the program produced nothing or something of another shape."""
    if got is None:
        return float("inf")
    got, ref = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    if got.shape != ref.shape:
        return float("inf")
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def rel_step(got, ref, start) -> float:
    """The gap of a step: rel(got - start, ref - start); a step left undone
    reads 1."""
    if got is None:
        return float("inf")
    start = torch.as_tensor(start).double()
    return rel(torch.as_tensor(got).double() - start, torch.as_tensor(ref).double() - start)


def limits(workload: str) -> Dict[str, float]:
    """The cell's limits, {} (no run correct) where it has none yet."""
    path = LIMITS / f"{workload}.json"
    return json.loads(path.read_text())["limits"] if path.exists() else {}


def judge(gaps: Dict[str, float], lims: Dict[str, float]) -> Tuple[bool, List[dict]]:
    """(every gap within its limit, [{name, value, limit}] in the limits'
    order).  A gap that is missing or not a number fails, and so does a
    run with no limits."""
    rows, ok = [], bool(lims)
    for name, limit in lims.items():
        value = gaps.get(name, float("nan"))
        good = value == value and value <= limit
        ok &= good
        rows.append({"name": name, "value": value, "limit": limit})
    return ok, rows

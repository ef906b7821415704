"""The numbers that decide ``correct``, each held to the limit in the cell's
``limits/<cell>.json``.

Serving (answers judged one by one): for every kept request, the program's
heat maps (the engine's sigmoid, on the host) beside the reference's sigmoid
of its float32 logits.

* ``heat_max_abs``: the widest gap at any pixel and class of any kept
  request;
* ``heat_worst_rms``: the root mean square gap of the worst kept request.
"""

from __future__ import annotations

import math

import numpy as np


def serving_numbers(pairs):
    """``pairs``: ``{request: (heat maps, reference heat maps)}``."""
    if not pairs:
        return {"heat_max_abs": math.nan, "heat_worst_rms": math.nan}
    max_abs, worst_rms = 0.0, 0.0
    for got, ref in pairs.values():
        if got.shape != ref.shape:
            return {"heat_max_abs": math.nan, "heat_worst_rms": math.nan}
        d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
        max_abs = max(max_abs, float(d.max()))
        worst_rms = max(worst_rms, float(np.sqrt((d * d).mean())))
    return {"heat_max_abs": max_abs, "heat_worst_rms": worst_rms}


def judge(numbers, limits):
    """``(correct, [(name, value, limit), ...])``: every number finite and
    at most its limit; a number without a limit, or a limit without a
    number, fails."""
    rows, ok = [], set(numbers) == set(limits)
    for name in sorted(set(numbers) | set(limits)):
        value = numbers.get(name, math.nan)
        limit = limits.get(name, {}).get("limit", math.nan)
        good = math.isfinite(value) and value <= limit
        ok = ok and good
        rows.append((name, value, limit))
    return ok, rows

"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample of
the answers that the window produced, drawn from the seed with the last
one always in it, is worked out again by the plain float64 reference from
the same inputs.  The kind of the cell's traffic (``kinds/<kind>.py``)
says which numbers are compared and how; each is held to its limit
(``limits/<workload>.json``).  A reading that is not finite fails.
"""

from __future__ import annotations

import math

from gpbench import generator


def worst(readings: list) -> float:
    """The largest reading, a reading that is not finite counting as
    infinite."""
    return max((r if math.isfinite(r) else math.inf) for r in readings)


def readings(cell, x, y, answers: list, seed: int, samples: int, detail: list | None = None) -> dict:
    """The numbers compared, each the worst over a seeded sample of
    ``samples`` answers."""
    sample = generator.check_sample(seed, len(answers), samples)
    return cell.kind.readings(cell, x, y, answers, sample, seed, detail)


def verdict(found: dict, limits: dict) -> tuple[bool, dict]:
    """(every reading within its limit, {name: {"value", "limit"}})."""
    table = {name: {"value": found[name], "limit": limit} for name, limit in limits.items()}
    return all(math.isfinite(row["value"]) and row["value"] <= row["limit"] for row in table.values()), table

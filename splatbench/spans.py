"""The program's own spans (``websplat_tpu_torch/utils/trace.py``), which
the host path's per-layer metrics read.  In a traced run the program
records them only while the harness's profiler records: the window and
the one unit before it, so these metrics average per call, not per unit.
A program without the trace module, or that recorded no such span, gives
None."""

from __future__ import annotations

from typing import List, Optional


def durations_ms(name: str) -> List[float]:
    """The host ms of every recorded span ``name``; [] where the program
    records none."""
    try:
        from websplat_tpu_torch.utils import trace
    except ImportError:
        return []
    return [(r.end_ns - r.start_ns) / 1e6 for r in trace.records() if r.name == name]


def mean_ms(*names: str) -> Optional[float]:
    """The sum over ``names`` of each span's mean host ms a call, or None
    where one of them was not recorded."""
    total = 0.0
    for name in names:
        spent = durations_ms(name)
        if not spent:
            return None
        total += sum(spent) / len(spent)
    return total

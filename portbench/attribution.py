"""A kernel family's share of its roofline in the traced window: the least
time its work allows (``yardstick``) over the device time of its kernels,
after their launches in the trace are held to the program's launch
counters over the same window.

A reader names its kernels: ``group``, every kernel function of the family
(its device time), and ``anchors``, counter -> the kernel functions of
which each counted call launches exactly one.
"""

from __future__ import annotations

from portbench import timeline as TL


class AttributionError(RuntimeError):
    """The trace's kernels and the program's counters disagree."""


def family_seconds(tl: TL.Timeline, group, anchors: dict, launches: dict) -> float | None:
    """Device seconds of ``group`` in the window; None when no counted
    call ran. Raises AttributionError when a counter's calls differ from
    the launches of its anchor kernels in the trace."""
    secs, counts = TL.kernel_seconds(tl, group)
    for counter, names in anchors.items():
        seen = sum(counts.get(k, 0) for k in names)
        if seen != launches.get(counter, 0):
            raise AttributionError(
                f"{counter}: {launches.get(counter, 0)} calls counted by the program, "
                f"{seen} launches of {sorted(names)} in the trace (kernels found: {counts})")
    if not any(launches.get(c, 0) for c in anchors):
        return None
    return secs


def roofline_pct(least_s: float, device_s: float | None) -> float | None:
    if device_s is None or device_s <= 0.0:
        return None
    return 100.0 * least_s / device_s

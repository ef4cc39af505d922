"""The trace reduction of scripts/step_profile.py on synthetic kernel events:
busy time is the union of intervals, and the census counts the kernels
that run a whole number of times per scan step."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import step_profile  # noqa: E402


@pytest.mark.parametrize("events,busy", [
    ([], 0.0),
    ([("a", 0, 10), ("b", 20, 5)], 15.0),               # disjoint
    ([("a", 0, 10), ("b", 5, 10)], 15.0),               # overlapping
    ([("a", 0, 30), ("b", 5, 10), ("c", 40, 1)], 31.0),  # nested
])
def test_busy_ns_is_union_of_intervals(events, busy):
    assert step_profile.busy_ns(events) == busy


def test_census_counts_per_step_kernels():
    n_steps = 4
    events = ([("loop_fusion", 100 * i, 2000) for i in range(n_steps)]
              + [("reduce", 100 * i + 50, 1000) for i in range(2 * n_steps)]
              + [("init_copy", 0, 500)])
    n_names, launches, us_per_step, lines = step_profile.census(events,
                                                                n_steps)
    assert n_names == 2
    assert launches == 3                      # 1 + 2 launches per step
    assert us_per_step == pytest.approx((2000 + 2 * 1000) / 1e3)
    assert any("init_copy" not in ln and "loop_fusion" in ln for ln in lines)
    assert lines[-1].startswith("other kernels: 1 names")

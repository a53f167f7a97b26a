"""``fused_backward``: the share of a window's bounces whose backward ran
the adjoint kernel, from the program's counters
(layer_metrics/fused_backward.py)."""

from types import SimpleNamespace

import pytest

from harness import spec


def _ctx(entries, count=40, ranks=1):
    return dict(window=SimpleNamespace(count=count),
                shapes=dict(spp=1, bounces=5),
                counters=[dict(launches={}, entries=dict(entries))
                          for _ in range(ranks)])


@pytest.mark.parametrize("entries, count, value", [
    ({"vsnray_bounce_shade_hit": 200, "vsnray_bounce_shade_bwd": 200}, 40,
     100.0),
    ({"vsnray_bounce_shade_hit": 200, "vsnray_bounce_shade_bwd": 0}, 40,
     0.0),
    ({"vsnray_bounce_shade_bwd": 100}, 40, 50.0),
    ({"vsnray_bounce_shade_hit": 200}, 40, None),
    ({}, 40, None),
    ({"vsnray_bounce_shade_bwd": 200}, 0, None),
])
def test_fused_backward_reads_the_adjoint_launches(entries, count, value):
    got = spec.reader("fused_backward.step").read(_ctx(entries, count))
    assert got == (None if value is None else pytest.approx(value))


def test_fused_backward_takes_the_mean_over_ranks():
    ctx = _ctx({"vsnray_bounce_shade_bwd": 200})
    ctx["counters"].append(dict(entries={"vsnray_traverse_lbvh": 400}))
    assert spec.reader("fused_backward.step").read(ctx) == \
        pytest.approx(50.0)

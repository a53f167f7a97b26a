"""``fused_bounces``: the share of a window's bounces that ran the hit
kernel, from the program's counters (layer_metrics/fused_bounces.py)."""

from types import SimpleNamespace

import pytest

from harness import spec


def _ctx(entries, count=40, ranks=1):
    return dict(window=SimpleNamespace(count=count),
                shapes=dict(spp=1, bounces=5),
                counters=[dict(launches={}, entries=dict(entries))
                          for _ in range(ranks)])


@pytest.mark.parametrize("entries, count, value", [
    ({"vsnray_traverse_lbvh": 400, "vsnray_bounce_shade_hit": 200}, 40,
     100.0),
    ({"vsnray_traverse_lbvh": 400, "vsnray_bounce_shade_hit": 0}, 40, 0.0),
    ({"vsnray_traverse_lbvh": 400, "vsnray_bounce_shade_hit": 50}, 40,
     25.0),
    ({"vsnray_traverse_lbvh": 400}, 40, None),
    ({}, 40, None),
    ({"vsnray_bounce_shade_hit": 200}, 0, None),
])
def test_fused_bounces_reads_the_hit_kernels_launches(entries, count, value):
    got = spec.reader("fused_bounces.frame").read(_ctx(entries, count))
    assert got == (None if value is None else pytest.approx(value))


def test_fused_bounces_takes_the_mean_over_ranks():
    ctx = _ctx({"vsnray_bounce_shade_hit": 200})
    ctx["counters"].append(dict(entries={"vsnray_traverse_lbvh": 400}))
    assert spec.reader("fused_bounces.frame").read(ctx) == \
        pytest.approx(50.0)

"""``grad_inplace_pct.train`` is found by name and reads the share of the
∇A write-back's pairs that the card added in place: 100 when every pair
did, None for a refresh, for a program without the counters and for a
window with no such pair."""
import json

import pytest

from perfbench import harness

NAME = "grad_inplace_pct.train"


def _ctx(entry, before, after, steps=2):
    snap = lambda f: {"fields": f, "busy": {}, "stall": {}}  # noqa: E731
    return harness.Context(entry, steps, 10.0, snap(before), snap(after),
                           {}, None, {}, 0.0, None)


def test_found_by_name_in_both_training_cells():
    bench = json.loads((harness.REPO / "BENCHMARK.json").read_text())
    (m,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert m["moves"] == "epoch_s" and m["unit"] == "%"
    assert m["workloads"] == ["gcn-igbm-3l.train_spill",
                              "gat-igbm-3l.train_resident"]
    assert callable(harness.metric_reader(NAME))


@pytest.mark.parametrize("entry,before,after,want", [
    ("train", {"scatter_inplace_pairs": 10, "scatter_copy_pairs": 0},
     {"scatter_inplace_pairs": 970, "scatter_copy_pairs": 0}, 100.0),
    ("train", {"scatter_inplace_pairs": 0, "scatter_copy_pairs": 0},
     {"scatter_inplace_pairs": 30, "scatter_copy_pairs": 10}, 75.0),
    ("train", {"scatter_inplace_pairs": 5, "scatter_copy_pairs": 5},
     {"scatter_inplace_pairs": 5, "scatter_copy_pairs": 5}, None),
    ("train", {"cache_hits": 0}, {"cache_hits": 3}, None),
    ("refresh", {"scatter_inplace_pairs": 0, "scatter_copy_pairs": 0},
     {"scatter_inplace_pairs": 4, "scatter_copy_pairs": 0}, None),
])
def test_reads_the_in_place_share(entry, before, after, want):
    got = harness.metric_reader(NAME)(_ctx(entry, before, after))
    assert got == (pytest.approx(want) if want is not None else None)

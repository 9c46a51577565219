"""The traced run's host side: the program's own span tracer, switched on
for a window, gives its stage spans on ``time.perf_counter_ns``, and the
device's idle gaps are named by the span that overlaps each most."""
import time

import numpy as np
import torch

from perfbench import harness
from perfbench.devtrace import DeviceTrace, HostSpans


def test_program_spans_cover_the_window():
    cell = harness.load_cell("gcn-igbm-3l.train_spill")
    cell.config.update(n_nodes=2048, n_parts=4)
    cell.traffic["checked_steps"] = 1
    from perfbench.entries.train import Entry

    entry = Entry(cell.config, cell.traffic, 5, torch.device("cpu"))
    entry.setup()
    try:
        spans = HostSpans(entry.counters)
        t0 = time.perf_counter_ns()
        spans.start()
        entry.step()
        got = spans.stop()
        t1 = time.perf_counter_ns()
    finally:
        entry.close()
    from repro_torch.obs import NULL_TRACER

    assert entry.counters.tracer is NULL_TRACER
    names = {n for n, _, _ in got}
    assert {"gather", "regather"} <= names, names
    assert all(t0 <= a <= b <= t1 for _, a, b in got)


def test_gaps_named_by_the_span_that_overlaps_most():
    ms = 1_000_000
    busy = np.array([[0, 10 * ms], [20 * ms, 30 * ms], [40 * ms, 41 * ms]],
                    dtype=np.int64)
    spans = [("gather", 9 * ms, 19 * ms), ("h2d", 12 * ms, 14 * ms),
             ("h2d", 30 * ms, 40 * ms)]
    gaps = dict(DeviceTrace._gaps(busy, 0, 50 * ms, spans, 0))
    assert gaps["gather"] == 0.01
    assert gaps["h2d"] == 0.01
    assert gaps["host_other"] == 0.009

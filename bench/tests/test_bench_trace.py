"""The reduction of a device trace to busy time, range device time and
idle gaps, on a made-up trace."""
from benchlib.trace import PREFIX, WINDOW, Event, _union, reduce_events


def ev(name, start, end, device=False, thread=1, corr=0, linked=0):
    return Event(name=name, device=device, start=start, end=end,
                 thread=thread, correlation=corr, linked=linked)


def test_device_side_ranges_are_not_operations():
    s = reduce_events([ev(WINDOW, 0, 100), ev(PREFIX + "flash", 0, 90,
                                               device=True),
                       ev("k", 10, 20, device=True)])
    assert s.busy_s == 10 / 1e9 and dict(s.device_ops) == {"k": 10 / 1e9}


def test_union_and_gaps():
    busy, gaps = _union([(0, 10), (5, 20), (30, 40), (35, 36)])
    assert busy == 30 and gaps == [(20, 30)]


def test_reduce():
    events = [
        ev(WINDOW, 0, 1000),
        ev(PREFIX + "flash", 100, 200),
        ev("cudaLaunchKernel", 110, 120, corr=7),
        ev("cudaLaunchKernel", 300, 310, corr=8),
        ev("aten::mm", 290, 320),
        ev("aten::item", 400, 900),
        ev("flash_kernel", 150, 300, device=True, linked=7),
        ev("untied_kernel", 300, 350, device=True),
        ev("gemm", 350, 450, device=True, linked=8),
        ev("gemm", 800, 900, device=True, linked=8),
        ev("late", 1200, 1300, device=True),       # outside the window
    ]
    s = reduce_events(events)
    assert s.window_s == 1000 / 1e9
    assert s.busy_s == 400 / 1e9
    assert s.range_device_s == {"flash": 200 / 1e9}
    assert s.range_calls == {"flash": 1}
    assert dict(s.device_ops) == {"flash_kernel": 150 / 1e9,
                                  "untied_kernel": 50 / 1e9,
                                  "gemm": 200 / 1e9}
    # the gap 450-800 began while the host sat in aten::item
    assert s.idle_gaps[0] == ("aten::item", 350 / 1e9)


def test_no_device_ops_no_summary():
    assert reduce_events([ev(WINDOW, 0, 10)]) is None
    assert reduce_events([ev("gemm", 0, 10, device=True)]) is None

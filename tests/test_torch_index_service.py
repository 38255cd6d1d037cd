"""The port's serving engine against the JAX package's, on one
reference-written index file and the same query batches.

Inputs: 50k keys < 2^30 (numpy seed 13), a dense 3-layer step/band/step
stack written paged (1 KiB pages, CRCs) by the JAX package, query batches
from numpy seed 3.  Tolerance: none — ranges, cache contents and counters
are identical (wall-clock fields excluded), and fault schedules replay
with identical ``fault_log``s.
"""
import dataclasses

import numpy as np
import pytest

from repro.api import RetryPolicy as RefRetry
from repro.api import ServeSpec as RefSpec
from repro.core import IndexDesign as RefDesign
from repro.core import KeyPositions as RefKP
from repro.core import write_index as ref_write_index
from repro.core.builders import build_gband, build_gstep
from repro.core.nodes import outline
from repro.serve import backend as ref_backend
from repro.serve import index_service as ref_is

from repro_torch.api import RetryPolicy, ServeSpec
from repro_torch.serve import backend, index_service
from repro_torch.serve import IndexService

PAGE = 1024
# fields that hold measured wall time, compared only in structure
WALL_FIELDS = {"pread_seconds", "descent_seconds", "prefetch_seconds",
               "overlapped_pread_seconds", "read_samples", "lookup_samples"}
# recoverable schedules of the chaos gate (serve_bench --chaos)
CHAOS = {"eio": dict(eio_rate=0.3, eio_attempts=2),
         "corrupt": dict(corrupt_rate=1.0, corrupt_attempts=1,
                         only_over_bytes=PAGE)}
CHAOS_RETRY = dict(max_attempts=4, backoff_s=1e-5, max_backoff_s=1e-3)


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    rng0 = np.random.default_rng(13)
    keys = np.unique(rng0.integers(1, 2**30, 50_000).astype(np.uint64))
    D = RefKP.fixed_record(keys, 16)
    l1 = build_gstep(D, 8, 2**6)
    o1 = outline(l1, D)
    l2 = build_gband(o1, 2**9)
    l3 = build_gstep(outline(l2, o1), 8, 2**7)
    path = str(tmp_path_factory.mktemp("torch_svc") / "idx.air")
    meta = ref_write_index(path, RefDesign(layers=(l1, l2, l3), data=D),
                           page_bytes=PAGE)
    rng = np.random.default_rng(3)
    batches = [rng.choice(keys, n) for n in (300, 1, 512, 77, 300)]
    meta_end = min(lm.offset for lm in meta.layers)
    return path, keys, batches, meta_end


def _counters(stats) -> dict:
    d = dataclasses.asdict(stats)
    out = {k: v for k, v in d.items() if k not in WALL_FIELDS}
    out["read_samples"] = [(r[0], r[2], r[3]) for r in stats.read_samples]
    out["lookup_samples"] = [r[0] for r in stats.lookup_samples]
    return out


def _cache(svc):
    return [list(t.keys()) for t in svc.cache.tiers], svc.cache.stats()


def _serve(ref: bool, path, batches, *, device="cpu", factory=None, **kw):
    spec = (RefSpec if ref else ServeSpec)(**kw)
    if ref:
        svc = ref_is.IndexService(path, spec=spec, backend_factory=factory)
    else:
        svc = IndexService(path, spec=spec, backend_factory=factory,
                           device=device)
    with svc:
        if kw.get("pipeline_depth"):
            out = svc.lookup_batches(batches)
        else:
            out = [svc.lookup(b) for b in batches]
    return out, svc


def _counters_common(port_stats, ref_stats) -> tuple:
    return _counters(port_stats), _counters(ref_stats)


@pytest.mark.parametrize("resident", [1, 2, 3])
@pytest.mark.parametrize("cache", [(64 << 10,), (8 << 10, 32 << 10)])
def test_numpy_backend_identical_ranges_cache_and_counters(index, resident,
                                                           cache):
    path, _, batches, _ = index
    kw = dict(resident_layers=resident, cache_bytes=cache, backend="numpy")
    want, ref = _serve(True, path, batches, **kw)
    got, port = _serve(False, path, batches, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert _cache(port) == _cache(ref)
    p, r = _counters_common(port.stats, ref.stats)
    assert p == r
    assert port.stats.hit_rate == ref.stats.hit_rate
    assert port.stats.query_modeled_seconds == ref.stats.query_modeled_seconds


@pytest.mark.parametrize("resident", [1, 2, 3])
def test_cuda_backend_on_cpu_matches_reference_jnp(index, resident):
    path, keys, batches, _ = index
    want, ref = _serve(True, path, batches, resident_layers=resident,
                       backend="jnp")
    got, port = _serve(False, path, batches, resident_layers=resident)
    assert port.spec.backend == "cuda"
    # a 3-deep prefix holds the bottom layer, wider than one plane: both
    # packages decline it and serve on the float64 walk
    assert port.device_active == ref.device_active == (resident < 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert port.stats.device_batches == ref.stats.device_batches \
        == (len(batches) if resident < 3 else 0)
    q = np.concatenate(batches)
    idx = np.searchsorted(keys, q)
    r = np.concatenate(got)
    assert np.all((r[:, 0] <= 16 * idx) & (r[:, 1] >= 16 * idx + 16))


@pytest.mark.parametrize("backend_name", ["numpy", "cuda"])
def test_pipelined_equals_sequential(index, backend_name):
    path, _, batches, _ = index
    kw = dict(resident_layers=2, cache_bytes=(8 << 10,),
              backend=backend_name)
    seq, _ = _serve(False, path, batches, **kw)
    piped, svc = _serve(False, path, batches, pipeline_depth=2, **kw)
    for a, b in zip(piped, seq):
        np.testing.assert_array_equal(a, b)
    assert svc.stats.pipelined_batches == len(batches)
    assert svc.stats.overlapped_preads > 0
    ref_piped, _ = _serve(True, path, batches, pipeline_depth=2,
                          **dict(kw, backend="numpy"))
    for a, b in zip(piped, ref_piped):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("schedule", sorted(CHAOS))
def test_chaos_schedules_identical(index, schedule):
    path, _, batches, meta_end = index
    clean, _ = _serve(False, path, batches, backend="numpy",
                      cache_bytes=(64 << 10,))
    results, logs, svcs = [], [], []
    for ref, be in ((True, ref_backend), (False, backend)):
        holder = []

        def factory(p, be=be, holder=holder):
            holder.append(be.FaultInjectingBackend(
                be.FileBackend(p), seed=11, page_bytes=PAGE,
                only_from_offset=meta_end, **CHAOS[schedule]))
            return holder[-1]

        retry = (RefRetry if ref else RetryPolicy)(**CHAOS_RETRY)
        out, svc = _serve(ref, path, batches, factory=factory,
                          backend="numpy", cache_bytes=(64 << 10,),
                          retry=retry)
        results.append(out)
        logs.append(holder[0].fault_log)
        svcs.append(svc)
    assert logs[0] and logs[1] == logs[0]
    for a, b, c in zip(results[1], results[0], clean):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    p, r = _counters_common(svcs[1].stats, svcs[0].stats)
    assert p == r


@pytest.mark.parametrize("fault", ["persistent_eio", "persistent_corrupt"])
def test_typed_failures_match_reference(index, fault):
    path, _, batches, meta_end = index
    kw = (dict(eio_rate=1.0, eio_attempts=None) if fault == "persistent_eio"
          else dict(corrupt_rate=1.0, corrupt_attempts=10**9,
                    page_bytes=PAGE))
    raised = []
    for ref, be in ((True, ref_backend), (False, backend)):
        retry = (RefRetry if ref else RetryPolicy)(**CHAOS_RETRY)
        try:
            _serve(ref, path, batches, backend="numpy", retry=retry,
                   factory=lambda p, be=be: be.FaultInjectingBackend(
                       be.FileBackend(p), seed=2, only_from_offset=meta_end,
                       **kw))
            raised.append(None)
        except be.StorageError as e:
            raised.append((type(e).__name__, vars(e)))
    assert raised[0] is not None and raised[1] == raised[0]


def test_tiered_block_cache_identical():
    rng = np.random.default_rng(4)
    ref = ref_is.TieredBlockCache((3 * 64, 5 * 64), 64)
    port = index_service.TieredBlockCache((3 * 64, 5 * 64), 64)
    for op, pid in zip(rng.integers(0, 3, 400), rng.integers(0, 20, 400)):
        pid = int(pid)
        if op == 0:
            assert port.get(pid) == ref.get(pid)
        elif op == 1:
            assert port.peek(pid) == ref.peek(pid)
        else:
            port.put(pid, bytes([pid]))
            ref.put(pid, bytes([pid]))
        assert (pid in port) == (pid in ref)
    assert [list(t.items()) for t in port.tiers] == \
        [list(t.items()) for t in ref.tiers]
    assert port.stats() == ref.stats() and port.n_tiers == ref.n_tiers


def test_serve_stats_reservoirs_and_snapshot_identical():
    ref, port = ref_is.ServeStats(sample_seed=5), \
        index_service.ServeStats(sample_seed=5)
    for st in (ref, port):
        r = np.random.default_rng(9)
        for _ in range(1500):
            st.record_read(int(r.integers(1, 9000)), float(r.random()),
                           overlapped=bool(r.random() < 0.2),
                           tainted=bool(r.random() < 0.1))
        for _ in range(700):
            st.record_lookup(int(r.integers(1, 500)), float(r.random()))
        st.queries, st.batches, st.pages_hit, st.pages_fetched = 9, 3, 5, 7
        st.descent_seconds, st.pread_modeled_seconds = 0.25, 0.5
    assert port.read_samples == ref.read_samples
    assert port.lookup_samples == ref.lookup_samples
    for p in (0.5, 0.9, 0.99):
        assert port.lookup_quantile(p) == ref.lookup_quantile(p)
    assert port.roofline() == ref.roofline()
    snap, ref_snap = port.snapshot(), ref.snapshot()
    assert snap == ref_snap
    assert index_service.ServeStats.from_snapshot(snap) == port
    assert index_service.ServeStats.from_snapshot(ref.snapshot()) == port
    with pytest.raises(ValueError):
        port.lookup_quantile(1.0)


def test_closed_service_and_empty_batches(index):
    path, _, batches, _ = index
    svc = IndexService(path, spec=ServeSpec(backend="numpy"), device="cpu")
    assert svc.lookup(np.empty(0, dtype=np.uint64)).shape == (0, 2)
    svc.close()
    svc.close()
    assert svc.stats.batches == 1
    with pytest.raises(RuntimeError, match="closed"):
        svc.lookup(batches[0])


def test_persist_stats_is_not_silently_ignored(index, tmp_path):
    import os
    import shutil
    src, _, batches, _ = index
    path = str(tmp_path / "idx.air")
    shutil.copy(src, path)
    with IndexService(path, spec=ServeSpec(persist_stats=True),
                      device="cpu") as svc:
        svc.lookup(batches[0])
    hist = index_service.load_stats_history(path)
    assert os.path.exists(index_service.stats_path(path)) and len(hist) == 1
    assert hist[0]["stats"]["queries"] == len(batches[0])
    assert hist == ref_is.load_stats_history(path)

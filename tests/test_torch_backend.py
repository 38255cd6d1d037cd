"""The port's storage seam and serving specs against the JAX package's.
Inputs: one random file (numpy seed 0) read through both packages'
backends with the same seeded fault schedules and the same read sequence.
Tolerance: none — equal bytes, equal ``fault_log``, equal error fields."""
import errno
import json

import numpy as np
import pytest

from repro.api import RetryPolicy as RefRetry
from repro.api import ServeSpec as RefSpec
from repro.serve import backend as ref_backend

from repro_torch.api import RetryPolicy, ServeSpec
from repro_torch.serve import backend

SCHEDULES = {
    "eio": dict(eio_rate=0.3, eio_attempts=2),
    "eio_persistent": dict(eio_rate=0.5, eio_attempts=None),
    "torn_read": dict(short_rate=0.4, short_attempts=2),
    "corrupt": dict(corrupt_rate=1.0, corrupt_attempts=1,
                    only_over_bytes=1024),
    "flaky_start": dict(fail_first=3),
    "stall": dict(stall_rate=0.3, stall_seconds=1e-5),
    "combined": dict(eio_rate=0.4, eio_attempts=1, short_rate=0.4,
                     short_attempts=1, corrupt_rate=0.8, corrupt_attempts=1,
                     stall_rate=0.3, stall_seconds=1e-5, stall_attempts=1,
                     only_over_bytes=1024, only_from_offset=512),
}


@pytest.fixture(scope="module")
def blob_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("backend") / "blob.bin"
    path.write_bytes(np.random.default_rng(0).integers(
        0, 256, 64 << 10).astype(np.uint8).tobytes())
    return str(path)


def _drive(be, reads):
    out = []
    for nbytes, off in reads:
        try:
            out.append(("ok", be.pread(nbytes, off)))
        except OSError as e:
            out.append(("err", e.errno))
    return out


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("seed", [0, 11])
def test_fault_log_identical(blob_path, schedule, seed):
    rng = np.random.default_rng(seed + 100)
    reads = [(int(n), int(o)) for n, o in
             zip(rng.choice([16, 1024, 3000, 4096, 8192], 60),
                 rng.integers(0, 60 << 10, 60))]
    reads += reads[:20]                    # retries advance attempt counters
    kw = dict(SCHEDULES[schedule], seed=seed, page_bytes=1024)
    ref = ref_backend.FaultInjectingBackend(
        ref_backend.FileBackend(blob_path), **kw)
    port = backend.FaultInjectingBackend(backend.FileBackend(blob_path), **kw)
    try:
        assert _drive(port, reads) == _drive(ref, reads)
        assert port.fault_log == ref.fault_log
        assert port.calls == ref.calls
    finally:
        ref.close()
        port.close()


def test_file_backend_and_pread_full_identical(blob_path):
    a, b = ref_backend.FileBackend(blob_path), backend.FileBackend(blob_path)
    try:
        assert a.size() == b.size() == 64 << 10
        for n, off in ((1, 0), (4096, 100), (10_000, (64 << 10) - 50),
                       (10, 1 << 20)):
            assert b.pread(n, off) == a.pread(n, off)
            assert backend.pread_full(b.fd, n, off) == \
                ref_backend.pread_full(a.fd, n, off)
    finally:
        a.close()
        b.close()
    b.close()                              # idempotent
    assert b.fd is None


def test_typed_errors_carry_the_same_fields():
    pairs = [
        (ref_backend.ReadError("x", path="p", offset=1, nbytes=2,
                               attempts=3),
         backend.ReadError("x", path="p", offset=1, nbytes=2, attempts=3)),
        (ref_backend.CorruptPageError("y", path="p", page_id=7),
         backend.CorruptPageError("y", path="p", page_id=7)),
        (ref_backend.DeadlineExceededError("z"),
         backend.DeadlineExceededError("z")),
    ]
    for ref_e, e in pairs:
        assert type(e).__name__ == type(ref_e).__name__
        assert str(e) == str(ref_e) and vars(e) == vars(ref_e)
        assert isinstance(e, backend.StorageError)
        assert [c.__name__ for c in type(e).__mro__] == \
            [c.__name__ for c in type(ref_e).__mro__]


def test_flaky_start_raises_eio():
    inner = backend.StorageBackend()
    be = backend.FaultInjectingBackend(inner, fail_first=1)
    with pytest.raises(OSError) as ei:
        be.pread(4, 0)
    assert ei.value.errno == errno.EIO
    assert be.fault_log == [("fail_first", 0, 4, 0)]


def test_retry_policy_matches_reference():
    for kw in ({}, dict(max_attempts=4, backoff_s=1e-5, max_backoff_s=1e-3),
               dict(pread_deadline_s=0.5, batch_deadline_s=2.0)):
        p, r = RetryPolicy(**kw), RefRetry(**kw)
        assert p.to_dict() == r.to_dict() and p.to_json() == r.to_json()
        assert [p.backoff(i) for i in range(8)] == \
            [r.backoff(i) for i in range(8)]
        assert RetryPolicy.from_json(r.to_json()) == p
        p.validate()
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0).validate()
    with pytest.raises(ValueError):
        RetryPolicy.from_dict({"bogus": 1})


@pytest.mark.parametrize("ref_backend_name,want", [
    ("pallas", "cuda"), ("jnp", "cuda"), ("numpy", "numpy")])
def test_serve_spec_reads_reference_json(ref_backend_name, want):
    ref = RefSpec(cache_bytes=(4096, 1 << 20), resident_layers=2,
                  backend=ref_backend_name, interpret=False,
                  pipeline_depth=2, retry=RefRetry(max_attempts=5))
    spec = ServeSpec.from_json(ref.to_json())
    assert spec.backend == want and spec.interpret is False
    assert spec.cache_bytes == (4096, 1 << 20)
    assert spec.retry == RetryPolicy(max_attempts=5)
    spec.validate()
    d = json.loads(ref.to_json())
    d.pop("backend")
    assert {k: v for k, v in spec.to_dict().items() if k != "backend"} == d


def test_serve_spec_round_trip_and_validation():
    spec = ServeSpec(cache_bytes=[1 << 20], retry={"max_attempts": 2})
    assert spec.backend == "cuda" and spec.retry.max_attempts == 2
    assert ServeSpec.from_json(spec.to_json()) == spec
    assert spec.replace(backend="numpy").validate().backend == "numpy"
    with pytest.raises(ValueError):
        ServeSpec(backend="torch").validate()
    with pytest.raises(ValueError):
        ServeSpec(cache_profile="tape").validate()   # named by neither
    with pytest.raises(ValueError):
        ServeSpec(prefetch_layers=0).validate()
    # persisted stats are ported: the knob validates and round-trips
    persisted = ServeSpec(persist_stats=True).validate()
    assert ServeSpec.from_json(persisted.to_json()).persist_stats is True

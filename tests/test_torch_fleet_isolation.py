"""The port's fleet failure isolation against the JAX package's, mirroring
``tests/test_fault_tolerance.py``'s fleet cases: three 3-layer shard files
(every lookup walks disk), the same queries, the same fault schedules
(the same post-open failures; ``FaultInjectingBackend`` under equal
seeds) → the same healthy masks, error types and shards, the same partial
outputs and availability masks, and the same health in
``stats_summary``.  No broad ``except`` widens the contract: a typed
cause survives by name.  The port serves on the CPU (``device="cpu"``)."""
import errno

import numpy as np
import pytest

import repro.api as RA
import repro.core as RC
import repro.fleet as RF
import repro.serve as RS
import repro_torch.api as PA
import repro_torch.core as PC
import repro_torch.fleet as PF
import repro_torch.serve as PS
from repro.fleet.fleet import _partition as ref_partition
from repro.serve.index_service import demo_serving_design as ref_demo
from repro_torch.fleet.fleet import _partition as port_partition

from conftest import make_keys

P = 1024
PACKAGES = {
    "reference": dict(api=RA, core=RC, fleet=RF, serve=RS,
                      partition=ref_partition, demo=ref_demo, kw={}),
    "port": dict(api=PA, core=PC, fleet=PF, serve=PS,
                 partition=port_partition, demo=PS.demo_serving_design,
                 kw={"device": "cpu"}),
}


def _retry(api):
    return api.ServeSpec(cache_bytes=(64 << 10,), retry=api.RetryPolicy(
        max_attempts=4, backoff_s=1e-5, max_backoff_s=1e-4))


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Each package writes the three shard files of
    ``test_fault_tolerance.py``'s fleet; they must be byte-identical, and
    both packages serve the reference's → (keys, map, paths, bases,
    the first layer byte of each file)."""
    d = tmp_path_factory.mktemp("isofleet")
    keys = make_keys("gmm", 20_000, seed=6)
    out = {}
    for name, pkg in PACKAGES.items():
        core = pkg["core"]
        D = core.KeyPositions.fixed_record(keys, 16)
        shard_map = pkg["fleet"].ShardMap.even_keys(D.keys, 3)
        parts, bases = pkg["partition"](D, shard_map)
        paths = []
        for i, part in enumerate(parts):
            p = str(d / f"{name}_{i}.air")
            core.write_index(p, pkg["demo"](part), page_bytes=P)
            paths.append(p)
        out[name] = (shard_map.bounds, paths, bases)
    (rb, rpaths, rbases), (pb, ppaths, pbases) = out.values()
    assert rb == pb and rbases == pbases
    for a, b in zip(rpaths, ppaths):
        assert open(a, "rb").read() == open(b, "rb").read()
    starts = [min(lm.offset for lm in PC.read_meta_path(p).layers)
              for p in rpaths]
    return keys, rb, rpaths, rbases, starts


def _service(pkg, bounds, paths, bases, factories=None):
    return pkg["fleet"].FleetService(
        pkg["fleet"].ShardMap(bounds=bounds), paths, bases, profile=None,
        specs=[_retry(pkg["api"])] * 3, backend_factories=factories,
        **pkg["kw"])


def _dies_after_open(serve):
    class DiesAfterOpen(serve.FileBackend):
        """Healthy while the service opens, then every pread raises."""
        armed = False

        def pread(self, nbytes, offset):
            if DiesAfterOpen.armed:
                raise OSError(errno.EIO, "injected post-open EIO")
            return super().pread(nbytes, offset)
    return DiesAfterOpen


def _corrupts_after_open(serve):
    class CorruptsAfterOpen(serve.FileBackend):
        """Healthy through open, then every pread reports persistent page
        corruption."""
        armed = False

        def pread(self, nbytes, offset):
            raw = super().pread(nbytes, offset)
            if CorruptsAfterOpen.armed:
                raise serve.CorruptPageError(
                    "injected persistent corruption", path=self.path,
                    page_id=int(offset) // P)
            return raw
    return CorruptsAfterOpen


def _observe(pkg, shards, case) -> dict:
    """One case against one package → what its fleet reports."""
    keys, bounds, paths, bases, starts = shards
    serve = pkg["serve"]
    rng = np.random.default_rng(2)
    qs = rng.choice(keys, 400)
    with _service(pkg, bounds, paths, bases) as svc:
        want = svc.lookup(qs)
    obs = {"want": want}
    sick = {"dies after open": 1, "corrupts after open": 2,
            "persistent seeded faults": 0}.get(case)
    if case == "closed shard service":
        with _service(pkg, bounds, paths, bases) as svc:
            svc.lookup(np.asarray(keys[:64]))
            svc.services[0].close()
            summary = svc.stats_summary()
        obs["rows"] = [(r["shard"], r["healthy"], r.get("queries"))
                       for r in summary["shards"]]
        obs["queries"] = summary["queries"]
        return obs
    if case == "recoverable seeded faults":
        def make(path):
            return serve.FaultInjectingBackend(
                serve.FileBackend(path), seed=7 + paths.index(path),
                eio_rate=0.5, eio_attempts=2, page_bytes=P,
                only_from_offset=starts[paths.index(path)])
        with _service(pkg, bounds, paths, bases, make) as svc:
            obs["got"] = svc.lookup(qs)
            obs["retries"] = [s.stats.io_retries for s in svc.services]
            obs["healthy"] = list(svc.healthy)
        return obs
    if case == "persistent seeded faults":
        def make(path):
            inner = serve.FileBackend(path)
            if path != paths[sick]:
                return inner
            return serve.FaultInjectingBackend(
                inner, seed=11, eio_rate=0.3, eio_attempts=None,
                page_bytes=P, only_from_offset=starts[sick])
    else:
        cls = (_dies_after_open if case == "dies after open"
               else _corrupts_after_open)(serve)

        def make(path):
            return cls(path) if path == paths[sick] \
                else serve.FileBackend(path)
    with _service(pkg, bounds, paths, bases, make) as svc:
        if case != "persistent seeded faults":
            cls.armed = True
        try:
            try:
                svc.lookup(qs)
                obs["raised"] = None
            except pkg["fleet"].ShardUnavailableError as e:
                obs["raised"] = (type(e).__name__, e.shard)
            obs["healthy"] = list(svc.healthy)
            obs["causes"] = [e.split(":")[0] if e else None
                             for e in svc.errors]
            out, avail = svc.lookup(qs, partial_results=True)
            obs["partial"] = (out, avail)
            obs["routed_sick"] = svc.shard_map.route(qs) == sick
            outs, avails = svc.lookup_batches([qs[:150], qs[150:]],
                                              partial_results=True)
            obs["batches"] = (np.concatenate(outs), np.concatenate(avails))
            summary = svc.stats_summary()
            obs["summary"] = (summary["unhealthy_shards"],
                              [r["healthy"] for r in summary["shards"]],
                              [(r["error"] or "").split(":")[0]
                               for r in summary["shards"]])
            svc.mark_healthy(sick)
            obs["after_repair"] = svc.stats_summary()["unhealthy_shards"]
        finally:
            if case != "persistent seeded faults":
                cls.armed = False
    return obs


def _equal(a, b):
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("case", [
    "dies after open", "corrupts after open", "closed shard service",
    "recoverable seeded faults", "persistent seeded faults"])
def test_fleet_failure_isolation_equals_the_reference(shards, case):
    ref = _observe(PACKAGES["reference"], shards, case)
    port = _observe(PACKAGES["port"], shards, case)
    assert ref.keys() == port.keys()
    for k in ref:
        assert _equal(port[k], ref[k]), k
    if "partial" in port:
        # the contract itself, as the reference's tests hold it
        out, avail = port["partial"]
        sick_keys = port["routed_sick"]
        np.testing.assert_array_equal(avail, ~sick_keys)
        np.testing.assert_array_equal(out[avail], port["want"][avail])
        assert (out[~avail] == -1).all()
        assert port["raised"][1] == int(np.flatnonzero(
            [not h for h in port["healthy"]])[0])
        assert port["after_repair"] == 0
    if case == "corrupts after open":
        assert port["causes"][2] == "CorruptPageError"
        assert port["summary"][2][2] == "CorruptPageError"
    if case == "recoverable seeded faults":
        np.testing.assert_array_equal(port["got"], port["want"])
        assert sum(port["retries"]) > 0 and all(port["healthy"])

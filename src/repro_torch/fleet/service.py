"""Scatter-gather serving across a fleet of per-shard index services.

A :class:`FleetService` is to a fleet what
:class:`repro_torch.serve.IndexService` is to one file: batched lookups in,
``(q, 2)`` byte ranges out.  Each batch is routed by the fleet's
:class:`~repro_torch.fleet.ShardMap` (one vectorized searchsorted), the
per-shard sub-batches run through each shard's own engine — block cache,
coalesced preads, fused resident descent, and (via
:meth:`lookup_batches`) the two-stage prefetch pipeline, all per shard —
and the results gather back in input order.  Shard files store positions
rebased to 0 (see :mod:`repro_torch.fleet.fleet`); the gather side adds each
shard's base back, so callers see one global byte space.

The scatter-gather is *bit-identical* to looking each key up in its
shard's service directly: routing only decides which engine serves a key,
never how.

Failure isolation: a shard whose engine exhausts its retry budget (any
:class:`repro_torch.serve.StorageError`) is marked *unhealthy* and taken out of
rotation instead of failing every later fleet call.  By default a lookup
touching an unhealthy (or just-failing) shard raises
:class:`ShardUnavailableError`; with ``partial_results=True`` the healthy
shards' results return alongside an explicit per-key availability mask —
the caller chooses fail-stop or degraded serving, the fleet never
silently drops keys.

Each shard's engine runs its resident descent where ``device`` says: the
card unless the caller names another, one ``fused_descent`` launch for
each non-empty shard sub-batch; without a card and with no device named,
opening the service raises.
"""
from __future__ import annotations

import numpy as np

from repro_torch.serve.backend import StorageError
from repro_torch.serve.index_service import IndexService

from .spec import ShardMap


class ShardUnavailableError(StorageError):
    """A lookup needed a shard that is unhealthy (its engine spent a retry
    budget earlier, or its backend just failed).  Carries ``shard`` and
    the underlying ``cause`` string; pass ``partial_results=True`` to get
    the healthy shards' results plus an availability mask instead."""

    def __init__(self, msg: str, *, shard=None, cause=None):
        super().__init__(msg)
        self.shard = shard
        self.cause = cause


class FleetService:
    """Serve batched lookups across per-shard :class:`IndexService`\\ s.

    Parameters
    ----------
    shard_map: the fleet's key-range partition (routes queries).
    paths:     per-shard index-file paths, in shard order.
    bases:     per-shard global byte offsets (added to results — shard
               files are written rebased to 0).
    profile:   deployment tier, shared by every shard (``modeled_seconds``
               accounting; same semantics as IndexService).
    specs:     per-shard :class:`repro_torch.api.ServeSpec` list — usually the
               fleet spec's serve template with each shard's
               ``cache_bytes`` overridden by the budget allocator.
    plan:      the :class:`repro_torch.fleet.CachePlan` that produced those
               cache sizes (introspection only; may be None).
    backend_factories:
               per-shard ``path -> StorageBackend`` list (or one factory
               for every shard) forwarded to each shard's engine — the
               chaos harness injects per-shard fault schedules here.
    device:    where every shard's resident descent runs, passed to each
               :class:`IndexService`: the card unless named (``"cpu"``
               runs the plain PyTorch version).
    """

    def __init__(self, shard_map: ShardMap, paths, bases, *,
                 profile="azure_ssd", specs=None, plan=None,
                 backend_factories=None, device=None):
        paths = list(paths)
        bases = [int(b) for b in bases]
        if len(paths) != shard_map.n_shards or len(bases) != len(paths):
            raise ValueError(
                f"shard count mismatch: map has {shard_map.n_shards}, "
                f"got {len(paths)} paths / {len(bases)} bases")
        if specs is None:
            specs = [None] * len(paths)
        if len(specs) != len(paths):
            raise ValueError(f"{len(specs)} specs for {len(paths)} shards")
        if backend_factories is None or callable(backend_factories):
            backend_factories = [backend_factories] * len(paths)
        if len(backend_factories) != len(paths):
            raise ValueError(f"{len(backend_factories)} backend factories "
                             f"for {len(paths)} shards")
        self.shard_map = shard_map
        self.paths = paths
        self.bases = bases
        self.plan = plan
        self.healthy: list[bool] = [True] * len(paths)
        self.errors: list[str | None] = [None] * len(paths)
        self.services: list[IndexService] = []
        try:
            for path, spec, bf in zip(paths, specs, backend_factories):
                self.services.append(
                    IndexService(path, profile=profile, spec=spec,
                                 backend_factory=bf, device=device))
        except Exception:
            self.close()
            raise

    def _mark_unhealthy(self, sid: int, exc: BaseException) -> None:
        """Take a shard out of rotation after its engine gave up (typed
        storage failure past the retry budget).  Its service object stays
        open — stats remain inspectable and an operator can swap in a
        repaired file and call :meth:`mark_healthy`."""
        self.healthy[sid] = False
        self.errors[sid] = f"{type(exc).__name__}: {exc}"

    def mark_healthy(self, sid: int) -> None:
        """Put a shard back in rotation (after repair / :meth:`swap`)."""
        self.healthy[sid] = True
        self.errors[sid] = None

    @property
    def n_shards(self) -> int:
        return len(self.services)

    # -- lookups ------------------------------------------------------------
    def lookup(self, queries, *, partial_results: bool = False):
        """Batched Alg. 1 across the fleet → (q, 2) int64 global byte
        ranges, in input order.  Identical to routing each key and calling
        its shard's service alone — scatter-gather changes scheduling,
        not results.

        A key routed to an unhealthy shard (or one that fails past its
        retry budget during this call) raises
        :class:`ShardUnavailableError` by default.  With
        ``partial_results=True`` the return is ``(out, available)``: rows
        of keys the fleet could not serve are ``(-1, -1)`` and their
        ``available`` mask entries False — healthy shards' results are
        exactly what the default path would have returned."""
        q = np.atleast_1d(np.asarray(queries, dtype=np.uint64))
        out = np.empty((len(q), 2), dtype=np.int64)
        avail = np.ones(len(q), dtype=bool)
        for sid, pos in self.shard_map.sub_batches(q):
            res = self._serve_shard(
                sid, pos, partial_results,
                lambda svc: svc.lookup(q[pos]) + self.bases[sid])
            if res is None:
                out[pos] = -1
                avail[pos] = False
            else:
                out[pos] = res
        if partial_results:
            return out, avail
        return out

    def _serve_shard(self, sid: int, pos, partial: bool, fn):
        """Run ``fn`` against shard ``sid``'s service under the fleet's
        failure-isolation contract: an unhealthy shard is skipped, a
        typed storage failure marks it unhealthy — then either None comes
        back (``partial``: the caller masks those keys) or the
        :class:`ShardUnavailableError` propagates."""
        if not self.healthy[sid]:
            if partial:
                return None
            raise ShardUnavailableError(
                f"shard {sid} ({self.paths[sid]!r}) is unhealthy: "
                f"{self.errors[sid]}", shard=sid, cause=self.errors[sid])
        try:
            return fn(self.services[sid])
        except StorageError as e:
            self._mark_unhealthy(sid, e)
            if partial:
                return None
            raise ShardUnavailableError(
                f"shard {sid} ({self.paths[sid]!r}) failed past its retry "
                f"budget: {e}", shard=sid, cause=str(e)) from e

    def lookup_batches(self, batches, *, partial_results: bool = False):
        """Serve a sequence of batches, keeping each shard's two-stage
        prefetch pipeline fed: every shard receives its sub-batches of
        *all* batches in one ``lookup_batches`` call (so its stage-1
        worker prefetches across batch boundaries), then results gather
        per input batch in input order.

        Failure isolation matches :meth:`lookup`; with
        ``partial_results=True`` the return is ``(outs, avails)`` — one
        availability mask per input batch, and a shard that fails mid-way
        masks *all* its keys in every batch (its pipeline results cannot
        be trusted to a batch boundary)."""
        batches = [np.atleast_1d(np.asarray(b, dtype=np.uint64))
                   for b in batches]
        outs = [np.empty((len(b), 2), dtype=np.int64) for b in batches]
        avails = [np.ones(len(b), dtype=bool) for b in batches]
        per_shard: dict[int, list] = {}
        for bi, b in enumerate(batches):
            for sid, pos in self.shard_map.sub_batches(b):
                per_shard.setdefault(sid, []).append((bi, pos))
        for sid in sorted(per_shard):
            subs = per_shard[sid]
            res = self._serve_shard(
                sid, None, partial_results,
                lambda svc: svc.lookup_batches(
                    [batches[bi][pos] for bi, pos in subs]))
            for (bi, pos), r in zip(subs, res if res is not None
                                    else [None] * len(subs)):
                if r is None:
                    outs[bi][pos] = -1
                    avails[bi][pos] = False
                else:
                    outs[bi][pos] = r + self.bases[sid]
        if partial_results:
            return outs, avails
        return outs

    # -- observation ---------------------------------------------------------
    def stats_summary(self) -> dict:
        """Fleet-wide aggregates plus per-shard snapshots.  The fleet's
        per-query observed cost is the traffic-weighted mean of the
        shards' (Eq. 6-comparable, open-amortized) per-query costs.

        Never raises on a sick shard: an unhealthy or already-closed
        service still gets a row (``healthy``/``error`` say why it is
        thin) — a fleet dashboard must render *because* something is
        wrong, not fail when it is."""
        per_shard = []
        tq = modeled = walk = 0.0
        preads = bytes_fetched = hits = fetched = 0
        n_unhealthy = 0
        for sid, svc in enumerate(self.services):
            row = {"shard": sid, "healthy": self.healthy[sid],
                   "error": self.errors[sid]}
            if not self.healthy[sid]:
                n_unhealthy += 1
            try:
                st = svc.stats
                row.update({
                    "queries": st.queries,
                    "hit_rate": st.hit_rate, "preads": st.preads,
                    "bytes_fetched": st.bytes_fetched,
                    "io_retries": st.io_retries,
                    "io_timeouts": st.io_timeouts,
                    "degraded_runs": st.degraded_runs,
                    "corrupt_pages": st.corrupt_pages,
                    "query_modeled_us": (st.query_modeled_seconds * 1e6
                                         if st.queries else None),
                    "cache_bytes": list(
                        svc.cache.cap_pages[i] * svc.page_bytes
                        for i in range(svc.cache.n_tiers)),
                })
            except StorageError as e:
                # typed failure while reading shard state: take the shard
                # out of rotation and surface the concrete class name —
                # operators key availability reports on it
                if self.healthy[sid]:
                    n_unhealthy += 1
                self._mark_unhealthy(sid, e)
                row["healthy"] = False
                row["error"] = self.errors[sid]
                per_shard.append(row)
                continue
            except Exception as e:   # closed / half-open shard: thin row
                row["error"] = row["error"] or f"{type(e).__name__}: {e}"
                per_shard.append(row)
                continue
            per_shard.append(row)
            tq += st.queries
            modeled += (st.modeled_seconds - st.open_modeled_seconds
                        + st.data_modeled_seconds)
            walk += st.walk_modeled_seconds
            preads += st.preads
            bytes_fetched += st.bytes_fetched
            hits += st.pages_hit
            fetched += st.pages_fetched
        touched = hits + fetched
        return {
            "queries": int(tq),
            "preads": preads,
            "bytes_fetched": bytes_fetched,
            "hit_rate": (hits / touched) if touched else 0.0,
            "query_modeled_us": (modeled / tq * 1e6) if tq else None,
            "walk_query_us": (walk / tq * 1e6) if tq else None,
            "plan": self.plan.to_dict() if self.plan is not None else None,
            "healthy_shards": len(self.services) - n_unhealthy,
            "unhealthy_shards": n_unhealthy,
            "shards": per_shard,
        }

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Close every shard service (each persists its own ServeStats
        snapshot next to its file when its spec says so)."""
        for svc in self.services:
            try:
                svc.close()
            # airlint: allow[typed-error-flow] -- best-effort shutdown: one
            # shard's close failure must not strand the remaining shards
            except Exception:
                pass

    def __enter__(self) -> "FleetService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

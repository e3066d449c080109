"""The built-in indicator catalog (the port's copy of
elasticsearch_tpu/health/indicators.py): eleven verdicts over the
node's existing signals.

Each indicator maps one subsystem's live stats to a status + typed
diagnosis (see ``health/indicator.py`` for the contract).
On the port's node the device indicators read the card:
``device_engine`` the ``hbm`` breaker (the resident segments' bytes
against its limit), the launch tracker's first calls of a kernel key
(telemetry/engine.py: PyTorch compiles nothing per shape, so its
"compile" rate is the rate of new keys, usually 0) and the mesh's
fallbacks; ``device_regime`` the flight recorder's regime and its
cohort fill over the window.
Storm-shaped verdicts (compile storms, rejection bursts, trip storms)
read *rates* off the metrics history ring — a point-in-time counter
cannot distinguish "300 compiles ever" from "300 compiles this minute".

``shard_availability_summary`` is the ONE shard-status implementation:
``_cluster/health``, ``_cat/health``, and the shards_availability
indicator all call it, so the surfaces cannot drift.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.health.indicator import (
    Diagnosis,
    HealthContext,
    HealthIndicator,
    HealthIndicatorResult,
    HealthStatus,
    Impact,
)

# trailing window the storm-shaped verdicts read off the history ring
HEALTH_RATE_WINDOW_S = 60.0

# breaker pressure
BREAKER_USED_YELLOW = 0.85      # used/limit ratio
BREAKER_TRIPS_RED = 5           # trips in window, any breaker

# indexing pressure
REJECTIONS_RED = 10             # rejections in window, any stage
PRESSURE_USED_YELLOW = 0.85     # current/limit ratio

# task backlog / cancellation storms
TASK_BACKLOG_YELLOW = 64        # concurrently-live tasks
CANCEL_STORM_YELLOW = 10        # cancellations in window
CANCEL_STORM_RED = 50

# device / engine
COMPILE_STORM_PER_MIN = 30.0    # fresh compiles per minute
HBM_USED_YELLOW = 0.85
MESH_FALLBACK_YELLOW = 0.10     # fallback fraction of mesh dispatches

# launch-path regime (flight recorder)
REGIME_DEGRADED_YELLOW_S = 5.0   # degraded seconds in window
REGIME_DEGRADED_RED_S = 45.0     # stuck: most of the window degraded
FILL_RATIO_YELLOW = 0.25         # filled/slots over the window
FILL_MIN_LAUNCHES = 32           # don't judge fill on a trickle

# noisy neighbor (tenant accounting): one tenant holding a majority
# share of a contended dimension over the window. Floors keep a
# trickle from indicting anyone; the ≥2-active-tenants monopoly guard
# keeps a single-tenant (or untagged-only) node green — sole use of an
# idle resource is not noise
NOISY_SHARE_YELLOW = 0.5
NOISY_SHARE_RED = 0.8
NOISY_SLOTS_FLOOR = 16           # cohort slots in window
NOISY_LAUNCH_MS_FLOOR = 50.0     # device launch-ms in window
NOISY_REJECTIONS_FLOOR = 5       # rejections + breaker trips in window

# workload SLO (workload-class accounting): a class burning its
# windowed error budget — violations vs the violation rate the
# availability target allows. The request floor keeps a trickle (one
# slow request against an empty class) from flipping the report
WORKLOAD_BURN_YELLOW = 100.0     # % of windowed budget burned
WORKLOAD_BURN_RED = 500.0        # burning 5x faster than allowed
WORKLOAD_REQUESTS_FLOOR = 8      # windowed requests before judging


def shard_availability_summary(
        cluster_state: Optional[Any]) -> Dict[str, Any]:
    """Shard-availability roll-up from a routing table (ref:
    ClusterStateHealth.java): red when any primary is not active,
    yellow when all primaries are active but some copy isn't, green
    otherwise. An empty/absent routing table is green (nothing to
    serve ⇒ nothing unavailable)."""
    counts = {"active_primary_shards": 0, "active_shards": 0,
              "relocating_shards": 0, "initializing_shards": 0,
              "unassigned_shards": 0, "unassigned_primary_shards": 0}
    if cluster_state is None:
        # single-process node: no routing table exists; every local
        # shard is served in-process, so availability is green by
        # construction (the caller may fill real counts)
        return {**counts, "status": HealthStatus.GREEN}
    for s in cluster_state.routing_table.all_shards():
        if s.active:
            counts["active_shards"] += 1
            if s.primary:
                counts["active_primary_shards"] += 1
        if s.relocating:
            counts["relocating_shards"] += 1
        elif s.state == "initializing":
            counts["initializing_shards"] += 1
        elif s.state == "unassigned":
            counts["unassigned_shards"] += 1
            if s.primary:
                counts["unassigned_primary_shards"] += 1
    if counts["unassigned_primary_shards"] > 0:
        status = HealthStatus.RED
    elif counts["unassigned_shards"] > 0 or counts["initializing_shards"] > 0:
        status = HealthStatus.YELLOW
    else:
        status = HealthStatus.GREEN
    return {**counts, "status": status}


class ShardsAvailabilityIndicator(HealthIndicator):
    """Ref: ShardsAvailabilityHealthIndicatorService.java."""

    name = "shards_availability"

    def compute(self, ctx: HealthContext) -> HealthIndicatorResult:
        summary = shard_availability_summary(ctx.cluster_state)
        status = summary.pop("status")
        impacts: List[Impact] = []
        diagnoses: List[Diagnosis] = []
        if status == HealthStatus.RED:
            symptom = (f"{summary['unassigned_primary_shards']} primary "
                       "shard(s) unavailable")
            impacts.append(Impact(
                id="primary_unassigned", severity=1,
                description="searches and writes against affected indices "
                            "fail or return partial results",
                impact_areas=["search", "ingest"]))
            diagnoses.append(Diagnosis(
                id="shards_availability:primary_unassigned",
                cause="primary shards have no assigned copy on any node",
                action="restore missing nodes or allocate replacements "
                       "via _cluster/reroute allocate_replica",
                affected_resources=_unassigned_indices(ctx, primary=True)))
        elif status == HealthStatus.YELLOW:
            n = (summary["unassigned_shards"]
                 + summary["initializing_shards"])
            symptom = f"{n} shard copy(ies) not fully available"
            impacts.append(Impact(
                id="replica_unassigned", severity=3,
                description="reduced redundancy: a node loss may make "
                            "data unavailable",
                impact_areas=["search"]))
            diagnoses.append(Diagnosis(
                id="shards_availability:replica_unassigned",
                cause="replica copies are unassigned or still recovering",
                action="wait for recovery to finish, or add data nodes",
                affected_resources=_unassigned_indices(ctx, primary=False)))
        else:
            symptom = "all shard copies are available"
        return HealthIndicatorResult(
            name=self.name, status=status, symptom=symptom,
            details=summary, impacts=impacts, diagnoses=diagnoses)


def _unassigned_indices(ctx: HealthContext, primary: bool) -> List[str]:
    out = set()
    if ctx.cluster_state is None:
        return []
    for s in ctx.cluster_state.routing_table.all_shards():
        if s.state in ("unassigned", "initializing") and \
                (s.primary if primary else not s.primary):
            out.add(s.index)
    return sorted(out)


class CircuitBreakerIndicator(HealthIndicator):
    """Breaker pressure: live used/limit ratios plus the trip *rate*
    off the ring — distinguishing a trip storm from boot-time history."""

    name = "circuit_breakers"

    def compute(self, ctx: HealthContext) -> HealthIndicatorResult:
        if ctx.breaker_service is None:
            return HealthIndicatorResult(
                name=self.name, status=HealthStatus.UNKNOWN,
                symptom="no breaker service wired")
        stats = ctx.breaker_service.stats()
        recent_trips = 0.0
        if ctx.history is not None:
            recent_trips = ctx.history.delta_total(
                "breaker.tripped", HEALTH_RATE_WINDOW_S)
        hot = []          # breakers at/over the used-ratio watermark
        for bname, b in sorted(stats.items()):
            limit = b.get("limit_size_in_bytes", -1)
            used = b.get("estimated_size_in_bytes", 0)
            if limit and limit > 0 and used / limit >= BREAKER_USED_YELLOW:
                hot.append(bname)
        details = {
            "recent_trips": recent_trips,
            "window_s": HEALTH_RATE_WINDOW_S,
            "breakers": {bname: dict(b) for bname, b in sorted(stats.items())},
        }
        impacts: List[Impact] = []
        diagnoses: List[Diagnosis] = []
        if recent_trips >= BREAKER_TRIPS_RED:
            status = HealthStatus.RED
            symptom = (f"circuit breakers tripped {int(recent_trips)} "
                       f"time(s) in the last {int(HEALTH_RATE_WINDOW_S)}s")
        elif recent_trips > 0 or hot:
            status = HealthStatus.YELLOW
            symptom = ("memory pressure: "
                       + (f"{int(recent_trips)} recent trip(s)"
                          if recent_trips > 0
                          else f"breakers near limit: {', '.join(hot)}"))
        else:
            status = HealthStatus.GREEN
            symptom = "no recent breaker trips and headroom on all breakers"
        if status != HealthStatus.GREEN:
            impacts.append(Impact(
                id="requests_rejected", severity=2,
                description="requests over the memory budget are rejected "
                            "with 429/circuit_breaking_exception",
                impact_areas=["search", "ingest"]))
            diagnoses.append(Diagnosis(
                id="circuit_breakers:pressure",
                cause="memory accounting is at or over breaker limits",
                action="reduce concurrent request sizes, raise "
                       "indices.breaker.*.limit, or add capacity",
                affected_resources=sorted(set(hot))))
        return HealthIndicatorResult(
            name=self.name, status=status, symptom=symptom,
            details=details, impacts=impacts, diagnoses=diagnoses)


class IndexingPressureIndicator(HealthIndicator):
    """Rejection bursts (ring delta) + live coordinating-memory ratio."""

    name = "indexing_pressure"

    def compute(self, ctx: HealthContext) -> HealthIndicatorResult:
        if ctx.indexing_pressure is None:
            return HealthIndicatorResult(
                name=self.name, status=HealthStatus.UNKNOWN,
                symptom="no indexing pressure tracker wired")
        stats = ctx.indexing_pressure.stats()
        mem = stats.get("memory", {})
        total = mem.get("total", {})
        limit = stats.get("limit_in_bytes") or mem.get("limit_in_bytes", 0)
        current = sum(v for k, v in mem.get("current", {}).items()
                      if isinstance(v, (int, float)))
        recent_rejections = 0.0
        if ctx.history is not None:
            recent_rejections = ctx.history.delta_total(
                "indexing_pressure.rejections", HEALTH_RATE_WINDOW_S)
        lifetime_rejections = sum(
            v for k, v in total.items() if k.endswith("_rejections"))
        details = {
            "recent_rejections": recent_rejections,
            "window_s": HEALTH_RATE_WINDOW_S,
            "lifetime_rejections": lifetime_rejections,
            "current_bytes": current,
            "limit_bytes": limit,
        }
        impacts: List[Impact] = []
        diagnoses: List[Diagnosis] = []
        saturated = bool(limit) and current / limit >= PRESSURE_USED_YELLOW
        if recent_rejections >= REJECTIONS_RED:
            status = HealthStatus.RED
            symptom = (f"{int(recent_rejections)} indexing rejection(s) in "
                       f"the last {int(HEALTH_RATE_WINDOW_S)}s")
        elif recent_rejections > 0 or saturated:
            status = HealthStatus.YELLOW
            symptom = ("indexing memory under pressure"
                       if saturated else
                       f"{int(recent_rejections)} recent indexing "
                       "rejection(s)")
        else:
            status = HealthStatus.GREEN
            symptom = "no recent indexing rejections"
        if status != HealthStatus.GREEN:
            impacts.append(Impact(
                id="writes_rejected", severity=2,
                description="bulk/index requests are shed with 429; "
                            "clients must back off and retry",
                impact_areas=["ingest"]))
            diagnoses.append(Diagnosis(
                id="indexing_pressure:saturation",
                cause="indexing memory in flight is at the configured "
                      "limit, shedding load",
                action="slow producers, shrink bulk sizes, or raise "
                       "indexing_pressure.memory.limit",
                affected_resources=[]))
        return HealthIndicatorResult(
            name=self.name, status=status, symptom=symptom,
            details=details, impacts=impacts, diagnoses=diagnoses)


class TaskBacklogIndicator(HealthIndicator):
    """Task-manager backlog depth and cancellation storms."""

    name = "task_backlog"

    def compute(self, ctx: HealthContext) -> HealthIndicatorResult:
        if ctx.task_manager is None:
            return HealthIndicatorResult(
                name=self.name, status=HealthStatus.UNKNOWN,
                symptom="no task manager wired")
        stats = ctx.task_manager.stats()
        current = stats.get("current", 0)
        recent_cancels = 0.0
        if ctx.history is not None:
            recent_cancels = ctx.history.delta_total(
                "tasks.cancelled", HEALTH_RATE_WINDOW_S)
        details = {
            "current": current,
            "peak_concurrent": stats.get("peak_concurrent", 0),
            "recent_cancellations": recent_cancels,
            "window_s": HEALTH_RATE_WINDOW_S,
            "bans": stats.get("bans", 0),
        }
        impacts: List[Impact] = []
        diagnoses: List[Diagnosis] = []
        if recent_cancels >= CANCEL_STORM_RED:
            status = HealthStatus.RED
            symptom = (f"cancellation storm: {int(recent_cancels)} "
                       f"task(s) cancelled in the last "
                       f"{int(HEALTH_RATE_WINDOW_S)}s")
        elif recent_cancels >= CANCEL_STORM_YELLOW or \
                current >= TASK_BACKLOG_YELLOW:
            status = HealthStatus.YELLOW
            symptom = (f"task backlog: {current} live task(s)"
                       if current >= TASK_BACKLOG_YELLOW else
                       f"{int(recent_cancels)} recent cancellation(s)")
        else:
            status = HealthStatus.GREEN
            symptom = f"{current} live task(s), no cancellation storms"
        if status != HealthStatus.GREEN:
            impacts.append(Impact(
                id="work_queueing", severity=3,
                description="requests queue behind a deep task backlog "
                            "or are being mass-cancelled",
                impact_areas=["search", "ingest"]))
            diagnoses.append(Diagnosis(
                id="task_backlog:congestion",
                cause="more concurrent work than the node is draining, "
                      "or clients are cancelling en masse",
                action="inspect GET /_tasks for the dominant action and "
                       "throttle its source",
                affected_resources=[]))
        return HealthIndicatorResult(
            name=self.name, status=status, symptom=symptom,
            details=details, impacts=impacts, diagnoses=diagnoses)


class RecoveryProgressIndicator(HealthIndicator):
    """Recovery stages + watchdog stall findings: a recovery
    that exists is yellow-at-worst; one that stopped moving bytes is
    red via the watchdog verdict."""

    name = "recovery_progress"

    def compute(self, ctx: HealthContext) -> HealthIndicatorResult:
        recoveries = ctx.recoveries or {}
        by_stage: Dict[str, int] = {}
        failed = []
        live = 0
        for rec in recoveries.values():
            by_stage[rec.stage] = by_stage.get(rec.stage, 0) + 1
            if rec.stage == "failed":
                failed.append(f"{rec.index}[{rec.shard_id}]")
            elif rec.stage not in ("done", "cancelled"):
                live += 1
        stalls = []
        if ctx.watchdog is not None:
            stalls = [f for f in ctx.watchdog.findings()
                      if f.get("kind") == "recovery"]
        details = {
            "recoveries_by_stage": dict(sorted(by_stage.items())),
            "live": live,
            "failed": sorted(failed),
            "stalled": [
                {"resource": f["resource"], "stalled_for_s": f["stalled_for_s"]}
                for f in stalls],
        }
        impacts: List[Impact] = []
        diagnoses: List[Diagnosis] = []
        if stalls:
            status = HealthStatus.RED
            symptom = f"{len(stalls)} recovery(ies) stalled (no byte progress)"
            impacts.append(Impact(
                id="recovery_stalled", severity=2,
                description="shard copies are not converging; redundancy "
                            "and relocation are stuck",
                impact_areas=["availability"]))
            diagnoses.append(Diagnosis(
                id="recovery_progress:stalled",
                cause="a recovery transferred no bytes for longer than "
                      "the watchdog threshold (source node down or "
                      "transfer wedged)",
                action="check source/target node liveness; cancel and "
                       "re-allocate via _cluster/reroute",
                affected_resources=sorted(f["resource"] for f in stalls)))
        elif failed:
            status = HealthStatus.YELLOW
            symptom = f"{len(failed)} recovery(ies) failed"
            diagnoses.append(Diagnosis(
                id="recovery_progress:failed",
                cause="recoveries ended in failure and await re-allocation",
                action="inspect GET /_recovery for the failure, then "
                       "reroute",
                affected_resources=sorted(failed)))
        elif live:
            status = HealthStatus.YELLOW
            symptom = f"{live} recovery(ies) in progress"
        else:
            status = HealthStatus.GREEN
            symptom = "no active recoveries"
        return HealthIndicatorResult(
            name=self.name, status=status, symptom=symptom,
            details=details, impacts=impacts, diagnoses=diagnoses)


class DeviceEngineIndicator(HealthIndicator):
    """Engine/device health: the rate of new kernel keys (ring), the
    device-memory watermark against the ``hbm`` breaker's limit, and
    the mesh's ``fallback.*`` ratios."""

    name = "device_engine"

    def compute(self, ctx: HealthContext) -> HealthIndicatorResult:
        compile_per_min = 0.0
        if ctx.history is not None:
            compile_per_min = 60.0 * ctx.history.rate(
                "engine.compile.count", HEALTH_RATE_WINDOW_S)
        hbm_ratio = 0.0
        if ctx.breaker_service is not None:
            hbm = ctx.breaker_service.stats().get("hbm", {})
            limit = hbm.get("limit_size_in_bytes", -1)
            if limit and limit > 0:
                hbm_ratio = hbm.get("estimated_size_in_bytes", 0) / limit
        fallback_ratio = 0.0
        mesh_enabled = False
        if ctx.mesh_stats:
            mesh_enabled = bool(ctx.mesh_stats.get("enabled"))
            counters = ctx.mesh_stats.get("counters", {})
            dispatches = sum(v for k, v in counters.items()
                             if k.startswith("dispatch."))
            fallbacks = sum(v for k, v in counters.items()
                            if k.startswith("fallback."))
            if dispatches + fallbacks > 0:
                fallback_ratio = fallbacks / (dispatches + fallbacks)
        details = {
            "compiles_per_min": compile_per_min,
            "hbm_used_ratio": round(hbm_ratio, 4),
            "mesh_enabled": mesh_enabled,
            "mesh_fallback_ratio": round(fallback_ratio, 4),
        }
        if ctx.engine_totals:
            details["compile_totals"] = {
                "count": ctx.engine_totals.get("count", 0),
                "ms": ctx.engine_totals.get("ms", 0),
                "cache_hits": ctx.engine_totals.get("cache_hits", 0),
            }
        problems = []
        if compile_per_min >= COMPILE_STORM_PER_MIN:
            problems.append("compile_storm")
        if hbm_ratio >= HBM_USED_YELLOW:
            problems.append("hbm_watermark")
        if mesh_enabled and fallback_ratio >= MESH_FALLBACK_YELLOW:
            problems.append("mesh_fallbacks")
        impacts: List[Impact] = []
        diagnoses: List[Diagnosis] = []
        if "compile_storm" in problems:
            status = HealthStatus.RED if compile_per_min >= \
                2 * COMPILE_STORM_PER_MIN else HealthStatus.YELLOW
            symptom = (f"compile storm: {compile_per_min:.1f} fresh "
                       "compiles/min")
            diagnoses.append(Diagnosis(
                id="device_engine:compile_storm",
                cause="query shapes keep reaching kernel keys never "
                      "seen before, each paying its first-call cost",
                action="inspect GET /_kernels for the churning entry "
                       "point and widen its shape buckets",
                affected_resources=[]))
        elif problems:
            status = HealthStatus.YELLOW
            symptom = "device pressure: " + ", ".join(sorted(problems))
            diagnoses.append(Diagnosis(
                id="device_engine:pressure",
                cause="device memory near its breaker limit and/or mesh "
                      "dispatches falling back to the host path",
                action="raise indices.breaker.hbm.limit, shrink resident "
                       "segments, or check mesh fallback counters",
                affected_resources=sorted(problems)))
        else:
            status = HealthStatus.GREEN
            symptom = "engine compiling within budget, HBM has headroom"
        if status != HealthStatus.GREEN:
            impacts.append(Impact(
                id="latency_degraded", severity=3,
                description="searches pay compile/eviction/fallback "
                            "latency instead of the fused device path",
                impact_areas=["search"]))
        return HealthIndicatorResult(
            name=self.name, status=status, symptom=symptom,
            details=details, impacts=impacts, diagnoses=diagnoses)


class NodeShutdownIndicator(HealthIndicator):
    """Rolling-upgrade visibility: shutdown markers registered in
    cluster-state metadata (PUT /_nodes/{id}/shutdown). GREEN with no
    markers, which is every report of a single node: it has no cluster
    state. The markers' verdicts (a restart window, a drain, a stalled
    drain) read the cluster layer, a later slice of the port: a node
    handed markers reports UNKNOWN and names them."""

    name = "node_shutdown"

    def compute(self, ctx: HealthContext) -> HealthIndicatorResult:
        state = ctx.cluster_state
        markers = getattr(getattr(state, "metadata", None),
                          "node_shutdowns", None)
        if not markers:
            return HealthIndicatorResult(
                name=self.name, status=HealthStatus.GREEN,
                symptom="no node shutdowns in progress")
        return HealthIndicatorResult(
            name=self.name, status=HealthStatus.UNKNOWN,
            symptom="node shutdown markers need the cluster layer, a "
                    "later slice of the port",
            details={"shutdowns": sorted(markers)})


class FlightRegimeIndicator(HealthIndicator):
    """Launch-path regime + batcher fill, off the flight recorder.

    Two storm-shaped verdicts the point-in-time engine stats cannot
    render: a node STUCK in the degraded launch regime (windowed
    ``flight.regime_seconds.degraded`` delta — a momentary flip that
    recovered stays green) and a CHRONICALLY under-filled batcher
    (windowed filled/slots ratio — cohort launches paying for capacity
    they don't use)."""

    name = "device_regime"

    def compute(self, ctx: HealthContext) -> HealthIndicatorResult:
        if ctx.flight is None:
            return HealthIndicatorResult(
                name=self.name, status=HealthStatus.UNKNOWN,
                symptom="no flight recorder wired")
        agg = ctx.flight.aggregates()
        regime = agg["regime"]["current"]
        degraded_s = 0.0
        launches = slots = filled = 0.0
        if ctx.history is not None:
            degraded_s = ctx.history.delta_total(
                "flight.regime_seconds.degraded", HEALTH_RATE_WINDOW_S)
            launches = ctx.history.delta_total(
                "flight.launches", HEALTH_RATE_WINDOW_S)
            slots = ctx.history.delta_total(
                "flight.launch.slots", HEALTH_RATE_WINDOW_S)
            filled = ctx.history.delta_total(
                "flight.launch.filled", HEALTH_RATE_WINDOW_S)
        fill_ratio = (filled / slots) if slots else None
        underfilled = (launches >= FILL_MIN_LAUNCHES
                       and fill_ratio is not None
                       and fill_ratio < FILL_RATIO_YELLOW)
        details = {
            "regime": regime,
            "latency_ema_ms": agg["regime"]["latency_ema_ms"],
            "last_flip": agg["regime"]["last_flip"],
            "degraded_seconds_in_window": degraded_s,
            "window_s": HEALTH_RATE_WINDOW_S,
            "launches_in_window": launches,
            "fill_ratio_in_window": fill_ratio,
        }
        impacts: List[Impact] = []
        diagnoses: List[Diagnosis] = []
        stuck = (regime == "degraded"
                 and degraded_s >= REGIME_DEGRADED_YELLOW_S)
        if stuck and degraded_s >= REGIME_DEGRADED_RED_S:
            status = HealthStatus.RED
            symptom = (f"node stuck in degraded launch regime for "
                       f"{degraded_s:.0f}s of the last "
                       f"{int(HEALTH_RATE_WINDOW_S)}s")
        elif stuck or underfilled:
            status = HealthStatus.YELLOW
            symptom = ("node in degraded launch regime"
                       if stuck else
                       f"cohort batcher chronically under-filled "
                       f"({100.0 * fill_ratio:.0f}% of slots used)")
        else:
            status = HealthStatus.GREEN
            symptom = ("launch path in fast regime"
                       if regime == "fast" else
                       "degraded flip recovered within the window")
        if stuck:
            flip = agg["regime"]["last_flip"] or {}
            impacts.append(Impact(
                id="slow_searches", severity=2,
                description="every device launch pays degraded "
                            "dispatch latency; search p99 inflates",
                impact_areas=["search"]))
            diagnoses.append(Diagnosis(
                id="device_regime:degraded",
                cause=f"launch latency EMA over the degraded "
                      f"threshold (last flip cause: "
                      f"{flip.get('cause', 'unknown')})",
                action="check host load and untracked readbacks "
                       "(GET /_flight_recorder?kind=readback); a "
                       "recompile storm shows in GET /_kernels",
                affected_resources=[ctx.node_id]))
        if underfilled:
            impacts.append(Impact(
                id="wasted_cohort_slots", severity=3,
                description="cohort launches run mostly-empty: "
                            "device time is spent on padding",
                impact_areas=["search"]))
            diagnoses.append(Diagnosis(
                id="device_regime:underfilled_batcher",
                cause=f"only {100.0 * fill_ratio:.0f}% of cohort "
                      f"slots carried a query over the window",
                action="lower search.batching max wait / bucket "
                       "sizes, or route more traffic at this node",
                affected_resources=[ctx.node_id]))
        return HealthIndicatorResult(
            name=self.name, status=status, symptom=symptom,
            details=details, impacts=impacts, diagnoses=diagnoses)


class NoisyNeighborIndicator(HealthIndicator):
    """Names the tenant monopolizing a contended resource.

    Reads the per-tenant counters TenantAccounting feeds the registry
    (windowed off the history ring, so a burst that recovered stays
    green) across three dimensions: batcher cohort occupancy
    (``tenant.cohort.slots``), device launch time (``tenant.launch.ms``),
    and shed load (``tenant.rejections`` + ``tenant.breaker.trips``).
    A dimension indicts only when (a) its in-window total clears a
    floor, (b) at least two tenants show in-window workload on ANY
    signal (the monopoly guard — a single-tenant or untagged node has
    no neighbors to be noisy toward; note the guard is cross-dimension:
    the classic hog is the ONLY tenant being rejected while the quiet
    tenant merely searches), and (c) one tenant's share crosses the
    yellow/red line. The diagnosis names the tenant."""

    name = "noisy_neighbor"

    # (dimension label, [metric names summed per tenant], window floor)
    _DIMENSIONS = (
        ("cohort_slots", ("tenant.cohort.slots",), NOISY_SLOTS_FLOOR),
        ("launch_ms", ("tenant.launch.ms",), NOISY_LAUNCH_MS_FLOOR),
        ("shed_load", ("tenant.rejections", "tenant.breaker.trips"),
         NOISY_REJECTIONS_FLOOR),
    )

    # workload signals that mark a tenant "present" for the monopoly
    # guard, beyond the contended dimensions themselves
    _ACTIVITY = ("tenant.search.requests", "tenant.indexing.bytes")

    def compute(self, ctx: HealthContext) -> HealthIndicatorResult:
        if ctx.tenants is None:
            return HealthIndicatorResult(
                name=self.name, status=HealthStatus.UNKNOWN,
                symptom="no tenant accounting wired")
        tenants = ctx.tenants.active_tenants()

        def windowed(metric: str, t: str) -> float:
            if ctx.history is None:
                return 0.0
            return ctx.history.delta(metric, HEALTH_RATE_WINDOW_S,
                                     tenant=t)

        active_in_window = sorted(
            t for t in tenants
            if any(windowed(m, t) > 0 for m in self._ACTIVITY)
            or any(windowed(m, t) > 0
                   for _d, ms, _f in self._DIMENSIONS for m in ms))
        details: Dict[str, Any] = {
            "window_s": HEALTH_RATE_WINDOW_S,
            "active_tenants": tenants,
            "active_in_window": active_in_window,
            "dimensions": {},
        }
        findings: List[Dict[str, Any]] = []
        for dim, metric_names, floor in self._DIMENSIONS:
            per_tenant: Dict[str, float] = {}
            for t in tenants:
                v = sum(windowed(m, t) for m in metric_names)
                if v > 0:
                    per_tenant[t] = round(v, 3)
            total = sum(per_tenant.values())
            dim_details: Dict[str, Any] = {
                "total_in_window": round(total, 3),
                "by_tenant": dict(sorted(per_tenant.items())),
            }
            if total >= floor and len(active_in_window) >= 2:
                top, top_v = max(per_tenant.items(),
                                 key=lambda kv: (kv[1], kv[0]))
                share = top_v / total
                dim_details["dominant"] = top
                dim_details["dominant_share"] = round(share, 3)
                if share >= NOISY_SHARE_YELLOW:
                    findings.append({
                        "dimension": dim, "tenant": top,
                        "share": share,
                        "status": (HealthStatus.RED
                                   if share >= NOISY_SHARE_RED
                                   else HealthStatus.YELLOW)})
            details["dimensions"][dim] = dim_details
        if not findings:
            return HealthIndicatorResult(
                name=self.name, status=HealthStatus.GREEN,
                symptom="no tenant dominates a contended resource",
                details=details)
        status = HealthStatus.worst(*(f["status"] for f in findings))
        worst = max(findings, key=lambda f: (
            HealthStatus._ORDER[f["status"]], f["share"], f["tenant"]))
        symptom = (f"tenant [{worst['tenant']}] holds "
                   f"{100.0 * worst['share']:.0f}% of "
                   f"{worst['dimension']} over the last "
                   f"{int(HEALTH_RATE_WINDOW_S)}s")
        impacts = [Impact(
            id="tenant_crowding", severity=2,
            description="other tenants' searches queue behind (or are "
                        "shed by) one tenant's workload; their p99 "
                        "and error budgets pay for it",
            impact_areas=["search", "ingest"])]
        diagnoses = [Diagnosis(
            id="noisy_neighbor:dominant_tenant",
            cause=f"tenant [{f['tenant']}] holds "
                  f"{100.0 * f['share']:.0f}% of {f['dimension']} "
                  f"in the window",
            action="inspect GET /_tenants/stats for the tenant's "
                   "qps/latency/indexing mix; throttle or isolate it "
                   "(item-5 QoS enforcement acts on this attribution)",
            affected_resources=[f["tenant"]]) for f in findings]
        return HealthIndicatorResult(
            name=self.name, status=status, symptom=symptom,
            details=details, impacts=impacts, diagnoses=diagnoses)


class WorkloadSloIndicator(HealthIndicator):
    """Names the workload class burning its error budget.

    Reads the per-class counters WorkloadAccounting feeds the registry
    (windowed off the history ring, so a burst that recovered stays
    green): for every active class with an objective, the windowed
    ``workload.slo.violations`` against ``workload.search.requests``
    becomes a budget-burn percentage (telemetry/shaping.py
    budget_burn_pct — the same math `/_workload/stats` renders). A
    class indicts only past a request floor; YELLOW when it burns its
    whole windowed budget, RED when it burns 5x that. The typed
    diagnosis names the burning class."""

    name = "workload_slo"

    def compute(self, ctx: HealthContext) -> HealthIndicatorResult:
        if ctx.workload is None:
            return HealthIndicatorResult(
                name=self.name, status=HealthStatus.UNKNOWN,
                symptom="no workload accounting wired")
        from elasticsearch_tpu_torch.telemetry.shaping import budget_burn_pct
        classes = ctx.workload.active_classes()

        def windowed(metric: str, c: str) -> float:
            if ctx.history is None:
                return 0.0
            return ctx.history.delta(metric, HEALTH_RATE_WINDOW_S,
                                     workload=c)

        details: Dict[str, Any] = {
            "window_s": HEALTH_RATE_WINDOW_S,
            "active_classes": classes,
            "classes": {},
        }
        findings: List[Dict[str, Any]] = []
        for c in classes:
            objective = ctx.workload.objective_ms(c)
            requests = windowed("workload.search.requests", c)
            violations = windowed("workload.slo.violations", c)
            entry: Dict[str, Any] = {
                "objective_ms": objective,
                "requests_in_window": round(requests, 3),
                "violations_in_window": round(violations, 3),
            }
            if objective is not None and \
                    requests >= WORKLOAD_REQUESTS_FLOOR:
                burn = budget_burn_pct(requests, violations)
                entry["budget_burn_pct"] = burn
                if burn >= WORKLOAD_BURN_YELLOW:
                    findings.append({
                        "class": c, "burn": burn,
                        "status": (HealthStatus.RED
                                   if burn >= WORKLOAD_BURN_RED
                                   else HealthStatus.YELLOW)})
            details["classes"][c] = entry
        if not findings:
            return HealthIndicatorResult(
                name=self.name, status=HealthStatus.GREEN,
                symptom="every workload class is inside its "
                        "error budget",
                details=details)
        status = HealthStatus.worst(*(f["status"] for f in findings))
        worst = max(findings, key=lambda f: (
            HealthStatus._ORDER[f["status"]], f["burn"], f["class"]))
        symptom = (f"workload class [{worst['class']}] burned "
                   f"{worst['burn']:.0f}% of its error budget over "
                   f"the last {int(HEALTH_RATE_WINDOW_S)}s")
        impacts = [Impact(
            id="workload_slo_burn", severity=2,
            description="requests in the burning class exceed their "
                        "latency objective faster than the "
                        "availability target allows; its users see "
                        "degraded service",
            impact_areas=["search"])]
        diagnoses = [Diagnosis(
            id="workload_slo:error_budget_burn",
            cause=f"class [{f['class']}] burned {f['burn']:.0f}% of "
                  f"its windowed error budget",
            action="inspect GET /_workload/stats for the class's "
                   "latency distribution; check noisy_neighbor for a "
                   "hog tenant, batcher fill for under-batching, and "
                   "the flight recorder's regime for a degraded "
                   "device path",
            affected_resources=[f["class"]]) for f in findings]
        return HealthIndicatorResult(
            name=self.name, status=status, symptom=symptom,
            details=details, impacts=impacts, diagnoses=diagnoses)


class RepositoryIntegrityIndicator(HealthIndicator):
    """Snapshot repository integrity: RED on structural damage found by
    ``verify_integrity()`` (generation mismatch, corrupted metadata,
    missing/corrupted blobs), YELLOW on an in-flight shard snapshot the
    watchdog says stopped uploading bytes. Nodes without a repositories
    service (or with no repositories registered) are GREEN-trivially."""

    name = "repository_integrity"

    def compute(self, ctx: HealthContext) -> HealthIndicatorResult:
        if ctx.repositories is None:
            return HealthIndicatorResult(
                name=self.name, status=HealthStatus.UNKNOWN,
                symptom="no repositories service on this node",
                details={})
        problems: List[Dict[str, Any]] = []
        repos = sorted(ctx.repositories.get_configs())
        for repo_name in repos:
            try:
                repo = ctx.repositories.get_repository(repo_name)
                for p in repo.verify_integrity():
                    problems.append({"repository": repo_name, **p})
            except Exception as exc:  # noqa: BLE001 — surfaced as RED
                problems.append({
                    "repository": repo_name, "kind": "unreadable",
                    "resource": repo_name, "detail": str(exc)})
        stalls = []
        if ctx.watchdog is not None:
            stalls = [f for f in ctx.watchdog.findings()
                      if f.get("kind") == "snapshot"]
        in_flight = []
        if ctx.snapshots is not None:
            in_flight = sorted(ctx.snapshots.in_progress)
        details = {
            "repositories": repos,
            "problems": problems,
            "in_flight": in_flight,
            "stalled": [
                {"resource": f["resource"],
                 "stalled_for_s": f["stalled_for_s"]}
                for f in stalls],
        }
        impacts: List[Impact] = []
        diagnoses: List[Diagnosis] = []
        if problems:
            status = HealthStatus.RED
            symptom = (f"{len(problems)} integrity problem(s) across "
                       f"{len({p['repository'] for p in problems})} "
                       "repository(ies)")
            impacts.append(Impact(
                id="repository_corruption", severity=1,
                description="snapshots in a damaged repository may not "
                            "restore; the disaster-recovery path is "
                            "compromised",
                impact_areas=["backup"]))
            diagnoses.append(Diagnosis(
                id="repository_integrity:corruption",
                cause="repository metadata or blobs are missing, "
                      "corrupted, or the generation pointer disagrees "
                      "with index-N contents",
                action="verify the backing storage, then re-register "
                       "the repository and take a fresh snapshot",
                affected_resources=sorted(
                    f"{p['repository']}:{p.get('resource', '')}"
                    for p in problems)))
        elif stalls:
            status = HealthStatus.YELLOW
            symptom = (f"{len(stalls)} in-flight shard snapshot(s) "
                       "stalled (no upload progress)")
            diagnoses.append(Diagnosis(
                id="repository_integrity:stalled_snapshot",
                cause="a shard snapshot stopped uploading bytes for "
                      "longer than the watchdog threshold",
                action="check the holding data node; cancel the "
                       "snapshot task to release leases and retry",
                affected_resources=sorted(f["resource"] for f in stalls)))
        elif in_flight:
            status = HealthStatus.GREEN
            symptom = (f"{len(in_flight)} snapshot(s) in progress, "
                       "uploads advancing")
        else:
            status = HealthStatus.GREEN
            symptom = ("repositories verified"
                       if repos else "no repositories registered")
        return HealthIndicatorResult(
            name=self.name, status=status, symptom=symptom,
            details=details, impacts=impacts, diagnoses=diagnoses)


# every HealthIndicator subclass in health/ appears here
DEFAULT_INDICATORS = (
    ShardsAvailabilityIndicator,
    CircuitBreakerIndicator,
    IndexingPressureIndicator,
    TaskBacklogIndicator,
    RecoveryProgressIndicator,
    DeviceEngineIndicator,
    NodeShutdownIndicator,
    FlightRegimeIndicator,
    NoisyNeighborIndicator,
    WorkloadSloIndicator,
    RepositoryIntegrityIndicator,
)

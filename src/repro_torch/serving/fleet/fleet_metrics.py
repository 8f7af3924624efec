"""Fleet-wide metric aggregation over per-replica ``ServeMetrics`` (a
copy of ``repro.serving.fleet.fleet_metrics``; framework-free).

A ``FleetMetrics`` holds the raw ``ServeMetrics.to_dict()`` snapshot of
each replica (keyed by replica index), the router's routing-decision
counters, and each replica's boot metadata.  ``merged()`` folds the
snapshots with ``ServeMetrics.merge`` — raw observations concatenate,
so the fleet p50/p95 in ``summary()["fleet"]`` are exact percentiles
over every request served anywhere, not averages of per-replica
averages.  ``summary()["per_replica"]`` keeps the per-process view the
merge erases: occupancy, request counts, and *steady-state recompiles*
(``compile_misses`` minus the warmup compiles reported in the
replica's ready metadata) — the fleet invariant is that this is 0 on
every replica once warm.  ``summary()["routing"]`` exposes the
router's decisions: affinity hits vs new groups vs spills, plus
requeue/loss accounting from the failure path.

The port compiles nothing per signature: a "compile" is the first run of
a (shape, lane-policy signature, bucket) triple on an engine
(``repro_torch.serving.metrics``), so a steady-state recompile is a
triple the replica's warmup did not run.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.serving.metrics import ServeMetrics, percentile

__all__ = ["FleetMetrics"]


class FleetMetrics:
    """Aggregates per-replica snapshots; see module docstring.

    ``per_replica`` maps replica idx -> ``ServeMetrics.to_dict()``
    snapshot; ``routing`` is the router's counter dict; ``meta`` maps
    replica idx -> the worker's ready metadata (pid, warmup_s,
    warmup_compiles, max_batch, buckets).  ``router_snap`` is an
    optional partial ``ServeMetrics`` dict of counters observed on the
    router itself (``duplicate_results``, ``stale_pong_kills``) —
    events no single worker can see — folded into ``merged()`` through
    the same tolerant wire-format merge as the replica snapshots.
    """

    def __init__(self, per_replica: Dict[int, dict],
                 routing: Optional[dict] = None,
                 meta: Optional[Dict[int, dict]] = None,
                 router_snap: Optional[dict] = None):
        self.per_replica = dict(per_replica)
        self.routing = dict(routing or {})
        self.meta = dict(meta or {})
        self.router_snap = dict(router_snap or {})

    def merged(self) -> ServeMetrics:
        """One ``ServeMetrics`` over the whole fleet (exact percentiles:
        raw observation lists are concatenated, never pre-aggregated),
        router-side counters included."""
        snaps = list(self.per_replica.values())
        if self.router_snap:
            snaps = snaps + [self.router_snap]
        return ServeMetrics.merge(snaps)

    def steady_recompiles(self, idx: int) -> Optional[int]:
        """Compile misses on replica ``idx`` beyond its boot warmup —
        0 is the steady-state invariant.  None if warmup accounting is
        unavailable for this replica."""
        snap = self.per_replica.get(idx)
        warm = self.meta.get(idx, {}).get("warmup_compiles")
        if snap is None or warm is None:
            return None
        return int(snap["compile_misses"]) - int(warm)

    def summary(self) -> Dict:
        """Three sections: ``fleet`` (merged ``ServeMetrics.summary()``
        plus replica counts), ``per_replica`` (occupancy / recompile
        breakdown the merge erases), ``routing`` (decision counters)."""
        fleet = self.merged().summary()
        fleet["replicas"] = len(self.per_replica)
        per_replica = {}
        for idx, snap in sorted(self.per_replica.items()):
            occ = snap["batch_occupancy"]
            per_replica[idx] = {
                "requests": len(snap["request_latencies"]),
                "batches": len(snap["batch_walls"]),
                "mean_occupancy": round(
                    sum(occ) / max(len(occ), 1), 3),
                "request_latency_p95_s": round(
                    percentile(snap["request_latencies"], 95), 4),
                "compile_misses": snap["compile_misses"],
                "warmup_compiles": self.meta.get(idx, {}).get(
                    "warmup_compiles"),
                "steady_recompiles": self.steady_recompiles(idx),
                "compiled_signatures": snap["compiled_signatures"],
            }
        return {
            "fleet": fleet,
            "per_replica": per_replica,
            "routing": dict(self.routing),
        }

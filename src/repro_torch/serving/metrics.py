"""Serving metrics (counterpart of ``repro.serving.metrics``): queue
depth, batch occupancy, latency percentiles, full-step fraction,
per-request full-step counts, time-to-first-result, compile accounting,
quality-SLO accounting, and policy-group and shape accounting.

``full_step_fraction`` charges every lane of a batch for each *batch
forward* (padded lanes burn the compute whenever any lane activates),
while ``request_full_steps`` records how many steps each request
actually activated — the per-request number that differs across lanes
of a mixed-policy batch.

"Compile" keeps the reference's names, but the port compiles nothing
per signature: it runs eagerly.  Here a **miss** is the first run of a
(shape, lane-policy signature, bucket) triple since the engine was
built, a **hit** any later run of it, and ``compiled_signatures`` the
number of triples seen (``DiffusionEngine.compiled_buckets()``).

One ``ServeMetrics`` instance per engine.  Recording is thread-safe:
client threads and the async engine's worker record concurrently under
one lock from the sanitizer factory (``make_lock``: a plain
``threading.Lock`` unless ``REPRO_SANITIZE=1``); ``summary()``
aggregates.

Fleet aggregation rides on three methods: ``to_dict()`` is the lossless
wire snapshot (plain lists / ints / floats, safe to pickle across a
process boundary, keys exactly the reference's, so the two packages'
snapshots merge), ``from_dict()`` reconstructs, and ``merge(parts)``
folds any number of snapshots-or-instances into one ``ServeMetrics``
whose ``summary()`` reports exact fleet-wide percentiles (raw
observations are concatenated, never pre-aggregated).  ``merge`` is
associative.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

from repro_torch.analysis.runtime import make_lock


def _metrics_lock() -> threading.Lock:
    """Default-factory hook: sanitizer-aware lock construction."""
    return make_lock("ServeMetrics._lock")


# snapshot schema: counters sum under merge, lists concatenate, and the
# optionals carry their own fold (min / max / sum-of-present)
_COUNTER_FIELDS = ("compile_hits", "compile_misses", "full_steps",
                   "total_steps", "budget_events_total", "shed_events",
                   "duplicate_results", "stale_pong_kills")
_LIST_FIELDS = ("batch_walls", "batch_buckets", "batch_occupancy",
                "batch_lane_spread", "request_waits", "request_latencies",
                "request_full_steps", "request_realized_errors",
                "queue_depths")
_OPTIONAL_FIELDS = ("time_to_first_result_s", "cache_state_bytes_per_lane",
                    "compiled_signatures")


def percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) without numpy."""
    if not xs:
        return 0.0
    ys = sorted(xs)
    k = max(0, min(len(ys) - 1, int(round(q / 100.0 * (len(ys) - 1)))))
    return float(ys[k])


@dataclasses.dataclass
class ServeMetrics:
    # compile cache
    compile_hits: int = 0
    compile_misses: int = 0
    # batch-level observations
    batch_walls: List[float] = dataclasses.field(default_factory=list)
    batch_buckets: List[int] = dataclasses.field(default_factory=list)
    batch_occupancy: List[float] = dataclasses.field(default_factory=list)
    batch_lane_spread: List[int] = dataclasses.field(default_factory=list)
    full_steps: int = 0
    total_steps: int = 0
    # request-level observations
    request_waits: List[float] = dataclasses.field(default_factory=list)
    request_latencies: List[float] = dataclasses.field(default_factory=list)
    request_full_steps: List[int] = dataclasses.field(default_factory=list)
    # quality SLO: per-request realized error (peak accumulated cache
    # error between full forwards, reported by error-feedback policies)
    # and the total count of budget-triggered full forwards
    request_realized_errors: List[float] = dataclasses.field(
        default_factory=list)
    budget_events_total: int = 0
    # latest scheduler shed counter (budgets relaxed under queue
    # pressure; requests are never dropped)
    shed_events: int = 0
    # queue depth samples (taken whenever the engine polls the queue)
    queue_depths: List[int] = dataclasses.field(default_factory=list)
    # futures whose second resolution was absorbed (requeue races on
    # the exactly-once path; see FleetRouter._finish / _serve)
    duplicate_results: int = 0
    # alive-but-unresponsive replicas killed by the router's monitor
    # (stale pong past stale_after_s).  Incremented router-side — the
    # latch in Replica.kill guarantees at most one per incarnation —
    # and summed across the fleet by the wire-format merge.
    stale_pong_kills: int = 0
    # async serving: seconds from serving start to the first resolved
    # result (None until observed)
    time_to_first_result_s: Optional[float] = None
    # actual per-lane cache-state footprint of the engine's policy
    # (spectral low ring included) — set once at warmup
    cache_state_bytes_per_lane: Optional[int] = None
    # latest jit-cache probe (None until pushed; -1 = probe unavailable)
    compiled_signatures: Optional[int] = None
    # per compatibility group:
    # [n_batches, n_requests, occupancy_sum, budget_events, errors]
    group_batches: Dict = dataclasses.field(default_factory=dict)
    # multi-resolution serving: per shape-key accounting
    # [n_batches, n_requests, occupancy_sum] — every batch is cut
    # shape-pure, so one key covers all its lanes
    shape_batches: Dict = dataclasses.field(default_factory=dict)
    # per-shape cache-state footprint (bytes/lane), set at warmup;
    # ``cache_state_bytes_per_lane`` stays the ladder maximum
    state_bytes_by_shape: Dict = dataclasses.field(default_factory=dict)
    _lock: threading.Lock = dataclasses.field(
        default_factory=_metrics_lock, repr=False, compare=False)

    # --- recording -------------------------------------------------------
    def observe_compile(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self.compile_hits += 1
            else:
                self.compile_misses += 1

    def observe_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depths.append(int(depth))

    def observe_first_result(self, elapsed_s: float) -> None:
        """Record time-to-first-result once (later calls are no-ops)."""
        with self._lock:
            if self.time_to_first_result_s is None:
                self.time_to_first_result_s = float(elapsed_s)

    def observe_state_bytes(self, nbytes: int,
                            shape_key: Optional[str] = None) -> None:
        """Record the engine policy's real per-lane cache footprint.
        With a ``shape_key`` the figure is also kept per ladder entry,
        and the scalar becomes the ladder maximum (the provisioning
        number for a multi-resolution deployment)."""
        with self._lock:
            if shape_key is not None:
                self.state_bytes_by_shape[str(shape_key)] = int(nbytes)
                self.cache_state_bytes_per_lane = max(
                    self.cache_state_bytes_per_lane or 0, int(nbytes))
            else:
                self.cache_state_bytes_per_lane = int(nbytes)

    def observe_compiled_signatures(self, n: int) -> None:
        """Record the engine's jit-cache probe (distinct compiled
        (bucket, lane-policy) signatures so far)."""
        with self._lock:
            self.compiled_signatures = int(n)

    def observe_shed_events(self, n: int) -> None:
        """Record the scheduler's cumulative shed counter (latest wins)."""
        with self._lock:
            self.shed_events = int(n)

    def observe_duplicate_result(self) -> None:
        """An already-resolved future was resolved again (requeue race
        on the exactly-once path); absorbed, never raised."""
        with self._lock:
            self.duplicate_results += 1

    def observe_stale_pong_kill(self) -> None:
        """A hung replica (stale pong) was killed by the monitor."""
        with self._lock:
            self.stale_pong_kills += 1

    def observe_batch(self, bucket: int, n_real: int, wall_s: float,
                      n_forwards: int, n_steps: int,
                      lane_full: Optional[List[int]] = None,
                      group_key=None,
                      lane_errors: Optional[List[float]] = None,
                      lane_events: Optional[List[int]] = None,
                      shape_key: Optional[str] = None) -> None:
        """``n_forwards`` — batch forwards actually run (compute);
        ``lane_full`` — per-real-lane activated-step counts (quality);
        ``group_key`` — the compatibility group this batch was cut from
        (None under the ungrouped former); ``lane_errors`` /
        ``lane_events`` — per-real-lane realized error and
        budget-triggered full counts from error-feedback policies;
        ``shape_key`` — the (latent, CRF) shape label of this
        (shape-pure) batch for per-resolution accounting."""
        with self._lock:
            if shape_key is not None:
                sb = self.shape_batches.setdefault(str(shape_key),
                                                   [0, 0, 0.0])
                sb[0] += 1
                sb[1] += int(n_real)
                sb[2] += n_real / max(bucket, 1)
            if group_key is not None:
                g = self.group_batches.setdefault(str(group_key),
                                                  [0, 0, 0.0, 0, []])
                g[0] += 1
                g[1] += int(n_real)
                g[2] += n_real / max(bucket, 1)
                if lane_events:
                    g[3] += int(sum(lane_events))
                if lane_errors:
                    g[4].extend(float(e) for e in lane_errors)
            if lane_full:
                # spread across lanes of one batch: 0 under a batch-global
                # decision, > 0 once lanes follow their own schedules
                self.batch_lane_spread.append(
                    max(lane_full) - min(lane_full))
            self.batch_walls.append(float(wall_s))
            self.batch_buckets.append(int(bucket))
            self.batch_occupancy.append(n_real / max(bucket, 1))
            # every lane (padded included) burns the compute of each batch
            # forward, so the compute fraction is forwards-based
            self.full_steps += int(n_forwards) * int(bucket)
            self.total_steps += int(n_steps) * int(bucket)

    def observe_request(self, wait_s: float, latency_s: float,
                        n_full: Optional[int] = None,
                        realized_error: Optional[float] = None,
                        budget_events: Optional[int] = None) -> None:
        with self._lock:
            self.request_waits.append(float(wait_s))
            self.request_latencies.append(float(latency_s))
            if n_full is not None:
                self.request_full_steps.append(int(n_full))
            if realized_error is not None:
                self.request_realized_errors.append(float(realized_error))
            if budget_events is not None:
                self.budget_events_total += int(budget_events)

    # --- aggregation -----------------------------------------------------
    @property
    def n_requests(self) -> int:
        return len(self.request_latencies)

    @property
    def n_batches(self) -> int:
        return len(self.batch_walls)

    def full_step_fraction(self) -> float:
        return self.full_steps / max(self.total_steps, 1)

    def summary(self) -> Dict:
        with self._lock:
            walls = list(self.batch_walls)
            lats = list(self.request_latencies)
            waits = list(self.request_waits)
            fulls = [float(v) for v in self.request_full_steps]
            spread = list(self.batch_lane_spread)
            buckets = list(self.batch_buckets)
            occ = list(self.batch_occupancy)
            depths = list(self.queue_depths)
            ttfr = self.time_to_first_result_s
            state_bytes = self.cache_state_bytes_per_lane
            hits, misses = self.compile_hits, self.compile_misses
            frac = self.full_steps / max(self.total_steps, 1)
            signatures = self.compiled_signatures
            errors = list(self.request_realized_errors)
            budget_events = self.budget_events_total
            shed = self.shed_events
            stale_kills = self.stale_pong_kills
            per_group = {
                k: {"batches": g[0], "requests": g[1],
                    "mean_occupancy": round(g[2] / max(g[0], 1), 3),
                    "budget_events": g[3],
                    "realized_error_p95": (round(percentile(g[4], 95), 6)
                                           if g[4] else None)}
                for k, g in self.group_batches.items()}
            per_shape = {
                k: {"batches": s[0], "requests": s[1],
                    "mean_occupancy": round(s[2] / max(s[0], 1), 3),
                    "state_bytes_per_lane":
                        self.state_bytes_by_shape.get(k)}
                for k, s in self.shape_batches.items()}
        return {
            "requests": len(lats),
            "batches": len(walls),
            "mean_occupancy": round(sum(occ) / max(len(walls), 1), 3),
            "mean_bucket": round(sum(buckets) / max(len(walls), 1), 2),
            "batch_wall_p50_s": round(percentile(walls, 50), 4),
            "batch_wall_p95_s": round(percentile(walls, 95), 4),
            "request_latency_p50_s": round(percentile(lats, 50), 4),
            "request_latency_p95_s": round(percentile(lats, 95), 4),
            "request_wait_p50_s": round(percentile(waits, 50), 4),
            "full_step_fraction": round(frac, 4),
            "skip_compute_fraction": round(1.0 - frac, 4),
            "request_full_p50": percentile(fulls, 50),
            # None (not 0.0) when no request carried a quality SLO
            "realized_error_p50": (round(percentile(errors, 50), 6)
                                   if errors else None),
            "realized_error_p95": (round(percentile(errors, 95), 6)
                                   if errors else None),
            "budget_events": budget_events,
            "shed_events": shed,
            "stale_pong_kills": stale_kills,
            "max_lane_full_spread": max(spread, default=0),
            "compile_hits": hits,
            "compile_misses": misses,
            "compiled_signatures": signatures,
            "policy_groups": len(per_group),
            "per_group": per_group,
            "shape_keys": len(per_shape),
            "per_shape": per_shape,
            "max_queue_depth": max(depths, default=0),
            "time_to_first_result_s": (None if ttfr is None
                                       else round(ttfr, 4)),
            "cache_state_bytes_per_lane": state_bytes,
        }

    def snapshot(self) -> "ServeMetrics":
        """Copy for before/after deltas (e.g. steady-state recompiles)."""
        with self._lock:
            return dataclasses.replace(
                self,
                batch_walls=list(self.batch_walls),
                batch_buckets=list(self.batch_buckets),
                batch_occupancy=list(self.batch_occupancy),
                batch_lane_spread=list(self.batch_lane_spread),
                request_waits=list(self.request_waits),
                request_latencies=list(self.request_latencies),
                request_full_steps=list(self.request_full_steps),
                request_realized_errors=list(self.request_realized_errors),
                queue_depths=list(self.queue_depths),
                group_batches={k: v[:4] + [list(v[4])]
                               for k, v in self.group_batches.items()},
                shape_batches={k: list(v)
                               for k, v in self.shape_batches.items()},
                state_bytes_by_shape=dict(self.state_bytes_by_shape),
                _lock=_metrics_lock(),
            )

    # --- serialization / fleet merge -------------------------------------
    def to_dict(self) -> Dict:
        """Lossless snapshot as plain python values — the wire format a
        replica worker ships to the fleet router (and the ONE sanctioned
        way to read raw counters from outside: benchmarks and the fleet
        aggregator go through this instead of reaching into fields)."""
        with self._lock:
            d = {f: getattr(self, f) for f in _COUNTER_FIELDS}
            d.update({f: list(getattr(self, f)) for f in _LIST_FIELDS})
            d.update({f: getattr(self, f) for f in _OPTIONAL_FIELDS})
            d["group_batches"] = {k: v[:4] + [list(v[4])]
                                  for k, v in self.group_batches.items()}
            d["shape_batches"] = {k: list(v)
                                  for k, v in self.shape_batches.items()}
            d["state_bytes_by_shape"] = dict(self.state_bytes_by_shape)
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "ServeMetrics":
        """Inverse of :meth:`to_dict` (``to_dict . from_dict == id``).

        Missing fields default (0 / [] / None) so snapshots written by
        an older wire schema — a replica one release behind its router
        — still load."""
        m = cls()
        for f in _COUNTER_FIELDS:
            setattr(m, f, int(d.get(f, 0)))
        for f in _LIST_FIELDS:
            setattr(m, f, list(d.get(f, ())))
        for f in _OPTIONAL_FIELDS:
            setattr(m, f, d.get(f))
        m.group_batches = {k: v[:4] + [list(v[4])]
                           for k, v in d.get("group_batches", {}).items()}
        # absent in pre-multires snapshots: default to empty (tolerant)
        m.shape_batches = {k: list(v)
                           for k, v in d.get("shape_batches", {}).items()}
        m.state_bytes_by_shape = dict(d.get("state_bytes_by_shape", {}))
        return m

    @classmethod
    def merge(cls, parts) -> "ServeMetrics":
        """Fold snapshots (``ServeMetrics`` or ``to_dict`` dicts) from
        independent engines into one fleet-wide instance.

        Counters sum, observation lists concatenate (so ``summary()``
        percentiles are exact fleet-wide, not averages of averages),
        ``time_to_first_result_s`` is the fleet minimum,
        ``cache_state_bytes_per_lane`` the maximum (replicas of one
        deployment report the same figure), and ``compiled_signatures``
        the fleet total of present probes.  Associative: merging merges
        gives the same ``summary()`` as merging everything at once.
        """
        merged = cls()
        for part in parts:
            d = part if isinstance(part, dict) else part.to_dict()
            for f in _COUNTER_FIELDS:
                setattr(merged, f, getattr(merged, f) + int(d.get(f, 0)))
            for f in _LIST_FIELDS:
                getattr(merged, f).extend(d.get(f, ()))
            ttfr = d.get("time_to_first_result_s")
            if ttfr is not None:
                cur = merged.time_to_first_result_s
                merged.time_to_first_result_s = (
                    ttfr if cur is None else min(cur, ttfr))
            cache_bytes = d.get("cache_state_bytes_per_lane")
            if cache_bytes is not None:
                cur = merged.cache_state_bytes_per_lane
                merged.cache_state_bytes_per_lane = max(
                    cur if cur is not None else 0, cache_bytes)
            sigs = d.get("compiled_signatures")
            if sigs is not None:
                cur = merged.compiled_signatures
                merged.compiled_signatures = (
                    (cur if cur is not None else 0) + sigs)
            for k, v in d.get("group_batches", {}).items():
                g = merged.group_batches.setdefault(k, [0, 0, 0.0, 0, []])
                g[0] += v[0]
                g[1] += v[1]
                g[2] += v[2]
                g[3] += v[3]
                g[4].extend(v[4])
            for k, v in d.get("shape_batches", {}).items():
                s = merged.shape_batches.setdefault(k, [0, 0, 0.0])
                s[0] += v[0]
                s[1] += v[1]
                s[2] += v[2]
            for k, v in d.get("state_bytes_by_shape", {}).items():
                # replicas of one deployment report the same figure
                merged.state_bytes_by_shape[k] = max(
                    merged.state_bytes_by_shape.get(k, 0), int(v))
        return merged


def throughput(metrics: ServeMetrics, wall_s: float) -> Optional[float]:
    if wall_s <= 0:
        return None
    return metrics.n_requests / wall_s

"""Serving metrics (counterpart of ``repro.serving.metrics``): what the
engine's execute path records, and ``summary()``.

``full_step_fraction`` charges every lane of a batch for each batch
forward (padded lanes burn the compute whenever any lane activates);
``request_full_steps`` records how many steps each request activated.
Recording is thread-safe under one lock.  The fleet wire format
(``to_dict`` / ``from_dict`` / ``merge``) arrives with the fleet slice.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional


def percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) without numpy."""
    if not xs:
        return 0.0
    ys = sorted(xs)
    k = max(0, min(len(ys) - 1, int(round(q / 100.0 * (len(ys) - 1)))))
    return float(ys[k])


@dataclasses.dataclass
class ServeMetrics:
    batch_walls: List[float] = dataclasses.field(default_factory=list)
    batch_buckets: List[int] = dataclasses.field(default_factory=list)
    batch_occupancy: List[float] = dataclasses.field(default_factory=list)
    batch_lane_spread: List[int] = dataclasses.field(default_factory=list)
    full_steps: int = 0
    total_steps: int = 0
    request_waits: List[float] = dataclasses.field(default_factory=list)
    request_latencies: List[float] = dataclasses.field(default_factory=list)
    request_full_steps: List[int] = dataclasses.field(default_factory=list)
    shed_events: int = 0
    queue_depths: List[int] = dataclasses.field(default_factory=list)
    # actual per-lane cache-state footprint per shape, set at warmup;
    # the scalar is the ladder maximum
    cache_state_bytes_per_lane: Optional[int] = None
    state_bytes_by_shape: Dict = dataclasses.field(default_factory=dict)
    # per compatibility group / shape: [n_batches, n_requests, occ_sum]
    group_batches: Dict = dataclasses.field(default_factory=dict)
    shape_batches: Dict = dataclasses.field(default_factory=dict)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    # --- recording -------------------------------------------------------
    def observe_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.queue_depths.append(int(depth))

    def observe_state_bytes(self, nbytes: int, shape_key: str) -> None:
        with self._lock:
            self.state_bytes_by_shape[str(shape_key)] = int(nbytes)
            self.cache_state_bytes_per_lane = max(
                self.cache_state_bytes_per_lane or 0, int(nbytes))

    def observe_shed_events(self, n: int) -> None:
        with self._lock:
            self.shed_events = int(n)

    def observe_batch(self, bucket: int, n_real: int, wall_s: float,
                      n_forwards: int, n_steps: int,
                      lane_full: Optional[List[int]] = None,
                      group_key=None,
                      shape_key: Optional[str] = None) -> None:
        """``n_forwards`` — batch forwards actually run (compute);
        ``lane_full`` — per-real-lane activated-step counts."""
        with self._lock:
            for table, key in ((self.group_batches, group_key),
                               (self.shape_batches, shape_key)):
                if key is not None:
                    row = table.setdefault(str(key), [0, 0, 0.0])
                    row[0] += 1
                    row[1] += int(n_real)
                    row[2] += n_real / max(bucket, 1)
            if lane_full:
                self.batch_lane_spread.append(max(lane_full) - min(lane_full))
            self.batch_walls.append(float(wall_s))
            self.batch_buckets.append(int(bucket))
            self.batch_occupancy.append(n_real / max(bucket, 1))
            self.full_steps += int(n_forwards) * int(bucket)
            self.total_steps += int(n_steps) * int(bucket)

    def observe_request(self, wait_s: float, latency_s: float,
                        n_full: Optional[int] = None) -> None:
        with self._lock:
            self.request_waits.append(float(wait_s))
            self.request_latencies.append(float(latency_s))
            if n_full is not None:
                self.request_full_steps.append(int(n_full))

    # --- aggregation -----------------------------------------------------
    @property
    def n_batches(self) -> int:
        return len(self.batch_walls)

    def summary(self) -> Dict:
        with self._lock:
            walls = list(self.batch_walls)
            lats = list(self.request_latencies)
            waits = list(self.request_waits)
            fulls = [float(v) for v in self.request_full_steps]
            occ = list(self.batch_occupancy)
            buckets = list(self.batch_buckets)
            frac = self.full_steps / max(self.total_steps, 1)

            def table(rows):
                return {k: {"batches": r[0], "requests": r[1],
                            "mean_occupancy": round(r[2] / max(r[0], 1), 3)}
                        for k, r in rows.items()}
            per_group = table(self.group_batches)
            per_shape = table(self.shape_batches)
            for k, row in per_shape.items():
                row["state_bytes_per_lane"] = self.state_bytes_by_shape.get(k)
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
                "shed_events": self.shed_events,
                "max_lane_full_spread": max(self.batch_lane_spread,
                                            default=0),
                "policy_groups": len(per_group),
                "per_group": per_group,
                "shape_keys": len(per_shape),
                "per_shape": per_shape,
                "max_queue_depth": max(self.queue_depths, default=0),
                "cache_state_bytes_per_lane":
                    self.cache_state_bytes_per_lane,
            }

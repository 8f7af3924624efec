"""One engine replica per child process, behind a command pipe (the
port's counterpart of ``repro.serving.fleet.worker``).

``worker_main`` is the child entry point: it applies per-replica env
overrides *before* importing torch (so a fleet can pin threads or the
visible card per worker), builds its ``DiffusionEngine`` from a pickled
zero-arg factory, warms the bucket ladder, wraps the engine in
``AsyncDiffusionEngine``, and then serves a tiny command protocol over
one duplex ``multiprocessing.connection`` pipe:

    ("submit", token, request)  -> ("result", token, DiffusionResult)
                                 | ("error", token, exception)
    ("ping", seq)               -> ("pong", seq, {depth, pending})
    ("metrics",)                -> ("metrics", ServeMetrics.to_dict())
    ("drain",)                  -> ("drained",)   (flushes partial batches)
    ("stop",) / SIGTERM         -> graceful drain, ("stopping",), exit

Results stream back *as batches complete* — the worker attaches a
done-callback to each future, so the command loop never blocks on
device work and pings stay answered while a batch executes.  SIGTERM is
a graceful drain: everything already queued is served before the
process exits (a SIGKILL is the crash case the router's requeue path
covers).  All sends share one lock; the loop polls so the SIGTERM flag
is observed promptly.

Nothing on the wire is a torch tensor: ``multiprocessing`` pickles
through torch's own reducers, which send a CPU tensor by shared memory
and a CUDA one by CUDA IPC, so it would land on the card again at the
other end.  Results leave the worker with their latents as a host numpy
array (the reference ships ``np.asarray`` too), and the router sends
``init_latents`` the same way.

``Replica`` is the parent-side handle: it spawns the process (spawn
context — never fork a process that holds a CUDA context), owns
the parent end of the pipe, and carries the router's per-replica
bookkeeping (in-flight map, health flag, boot metadata).

For chaos testing, ``worker_main`` takes an optional ``fault`` spec
(a plain dict produced by ``FaultInjector.spec_for``) as a *separate*
process argument — separate because boot faults must fire before
``pickle.loads(payload)`` pulls in the factory's module (and torch),
keeping injected boot failures cheap and prompt.
"""
from __future__ import annotations

import os
import pickle
import signal
import threading
import time
import traceback
from typing import Optional

from repro_torch.analysis.runtime import make_lock

__all__ = ["Replica", "worker_main"]


def _wire_exc(e: BaseException) -> BaseException:
    """The exception itself when picklable, else a carrier with its text."""
    try:
        pickle.dumps(e)
        return e
    except Exception:
        return RuntimeError(f"{type(e).__name__}: {e}")


def worker_main(conn, env: dict, payload: bytes, fault=None) -> None:
    """Child-process entry: build, warm, serve until stop/SIGTERM.

    ``payload`` is ``pickle.dumps((factory, warm))`` — deferred so the
    factory's module (and therefore torch) is imported only after
    ``env`` is applied.  ``warm`` maps straight onto
    ``DiffusionEngine.warmup`` kwargs (``buckets`` / ``policies`` /
    ``lane_policy_sets``).

    ``fault`` is an optional scripted-fault spec (see ``faults.py``);
    ``None`` in production.
    """
    os.environ.update(env)
    fault = dict(fault or {})
    stop_flag = threading.Event()
    try:
        # SIGTERM = graceful drain (the router's polite shutdown and any
        # process supervisor's default); SIGKILL remains the crash case
        signal.signal(signal.SIGTERM, lambda s, f: stop_flag.set())
    except ValueError:
        pass

    # injected boot faults fire before the payload is even unpickled —
    # the parent must handle never-ready workers however early they die
    if fault.get("boot_hang_s"):
        time.sleep(float(fault["boot_hang_s"]))
    if fault.get("boot_fail"):
        try:
            conn.send(("boot_error", "injected boot failure"))
        finally:
            conn.close()
        return

    try:
        factory, warm = pickle.loads(payload)
        engine = factory()
        warm = dict(warm or {})
        warm_s = engine.warmup(
            buckets=warm.get("buckets"),
            lane_policy_sets=warm.get("lane_policy_sets", ()),
            policies=warm.get("policies", ()),
            shapes=[tuple(map(tuple, s))
                    for s in warm.get("shapes", ())])
        # the port compiles nothing: these are first runs of a (shape,
        # signature, bucket) triple (``repro_torch.serving.metrics``)
        warm_compiles = engine.metrics_dict()["compile_misses"]
        from repro_torch.serving.async_engine import AsyncDiffusionEngine
        aeng = AsyncDiffusionEngine(engine).start()
    except BaseException:
        try:
            conn.send(("boot_error", traceback.format_exc()))
        finally:
            conn.close()
        return

    send_lock = make_lock("worker.send_lock")

    def send(msg) -> None:
        with send_lock:
            try:
                conn.send(msg)
            except (OSError, ValueError, BrokenPipeError):
                pass            # router is gone; keep draining regardless

    result_delay_s = float(fault.get("result_delay_s") or 0.0)

    def on_done(token: int):
        # runs on the async engine's worker thread the moment the
        # request's batch finishes — results stream, commands never wait
        def cb(fut):
            if result_delay_s:
                time.sleep(result_delay_s)
            try:
                res = fut.result()
            except BaseException as e:
                send(("error", token, _wire_exc(e)))
            else:
                # off the card and out of torch before the pipe (see the
                # module docstring)
                send(("result", token, res._replace(
                    latents=res.latents.detach().cpu().numpy())))
        return cb

    send(("ready", {
        "pid": os.getpid(),
        "warmup_s": warm_s,
        "warmup_compiles": warm_compiles,
        "max_batch": engine.max_batch,
        "buckets": list(engine.buckets),
        # shape ladder: lists (not tuples) so the wire dict stays plain;
        # the router re-tuples before validating submits against it
        "shapes": [[list(lat), list(crf)] for lat, crf in engine.shapes],
        "default_shape": [list(engine.latent_shape),
                          list(engine.crf_shape)],
    }))

    kill_after_submits = int(fault.get("kill_after_submits") or 0)
    kill_on_request_id = fault.get("kill_on_request_id")
    ignore_pings_after = int(fault.get("ignore_pings_after") or 0)
    submits_seen = pings_seen = 0

    # at most one drain flusher in flight: FleetRouter.drain() re-sends
    # ("drain",) every tick, and each used to spawn a fresh thread
    drain_thread: list = [None]

    def drain_and_ack() -> None:
        try:
            aeng.drain()
            send(("drained",))
        finally:
            drain_thread[0] = None

    while not stop_flag.is_set():
        if not conn.poll(0.1):
            continue
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break               # router vanished: drain what we have, exit
        cmd = msg[0]
        if cmd == "submit":
            _, token, req = msg
            submits_seen += 1
            # injected crash: die exactly like SIGKILL would — no drain,
            # no goodbye message, the parent just sees the pipe EOF
            if (kill_after_submits and submits_seen >= kill_after_submits) \
                    or (kill_on_request_id is not None
                        and getattr(req, "request_id", None)
                        == kill_on_request_id):
                os._exit(113)
            try:
                fut = aeng.submit(req)
            except BaseException as e:
                send(("error", token, _wire_exc(e)))
                continue
            fut.add_done_callback(on_done(token))
        elif cmd == "ping":
            pings_seen += 1
            if ignore_pings_after and pings_seen > ignore_pings_after:
                continue        # injected hang: alive but silent
            send(("pong", msg[1], {"depth": engine.scheduler.depth,
                                   "pending": aeng.pending()}))
        elif cmd == "metrics":
            send(("metrics", engine.metrics_dict()))
        elif cmd == "drain":
            # flush partial batches off the command loop so pings keep
            # flowing while the tail drains
            t = drain_thread[0]
            if t is None or not t.is_alive():
                t = threading.Thread(target=drain_and_ack,
                                     name="fleet-worker-drain", daemon=True)
                drain_thread[0] = t
                t.start()
        elif cmd == "stop":
            break

    try:
        aeng.shutdown(drain=True)       # graceful: serve the queue first
    except BaseException:
        pass
    send(("stopping",))
    conn.close()


class Replica:
    """Parent-side handle: spawned process + pipe + router bookkeeping."""

    def __init__(self, idx: int, factory, warm=None, env=None, ctx=None,
                 fault=None, start_n: int = 0):
        if ctx is None:
            import multiprocessing as mp
            ctx = mp.get_context("spawn")
        parent_conn, child_conn = ctx.Pipe()
        payload = pickle.dumps((factory, dict(warm or {})))
        self.idx = idx
        self.start_n = start_n        # which incarnation of this slot
        self.proc = ctx.Process(
            target=worker_main,
            args=(child_conn, dict(env or {}), payload, dict(fault or {})),
            name=f"fleet-replica-{idx}", daemon=True)
        self.spawned_at = time.monotonic()
        self.proc.start()
        child_conn.close()
        self.conn = parent_conn
        self.send_lock = make_lock("Replica.send_lock")
        # router bookkeeping (guarded by the router's lock)
        self.inflight: dict = {}      # token -> (request, Future, deaths)
        self.healthy = False          # True from ready until death/stop
        self.stopped = False          # clean stop observed
        self.probation = False        # reserved for an isolation probe
        self.kill_requested = False   # kill() latch: fire at most once
        self.meta: dict = {}
        self.boot_s: Optional[float] = None   # spawn -> ready read
        self.last_pong = time.monotonic()
        self.metrics_event = threading.Event()
        self.metrics_box: list = []

    def wait_ready(self, timeout: float) -> dict:
        """Block until the worker finished boot + warmup (or raise)."""
        if not self.conn.poll(timeout):
            raise TimeoutError(
                f"replica {self.idx} did not become ready in {timeout}s")
        msg = self.conn.recv()
        if msg[0] == "boot_error":
            raise RuntimeError(
                f"replica {self.idx} failed to boot:\n{msg[1]}")
        if msg[0] != "ready":
            raise RuntimeError(
                f"replica {self.idx}: expected ready, got {msg[0]!r}")
        self.meta = msg[1]
        self.boot_s = time.monotonic() - self.spawned_at
        self.healthy = True
        self.last_pong = time.monotonic()
        return self.meta

    def send(self, msg) -> None:
        """Thread-safe send (submit path, monitor pings, control)."""
        with self.send_lock:
            self.conn.send(msg)

    def kill(self) -> bool:
        """Request a hard kill; latched so repeated calls (the monitor
        re-checking a stale replica every tick) fire at most once.
        Returns True only for the call that actually issued the kill."""
        if self.kill_requested:
            return False
        self.kill_requested = True
        if self.proc.is_alive():
            self.proc.kill()
        return True

    def destroy(self, join_timeout: float = 5.0) -> None:
        """Tear the replica fully down: kill, reap, close the pipe.

        The cleanup path for workers that never became ready (boot
        timeout / ``boot_error``) and for shutdown — without the join
        the child lingers as a zombie, and without the close its pipe
        fds leak for the router's lifetime."""
        self.kill()
        try:
            self.proc.join(join_timeout)
        except Exception:
            pass
        try:
            self.conn.close()
        except Exception:
            pass

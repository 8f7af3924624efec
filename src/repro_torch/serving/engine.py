"""Continuous-batching serving of the FreqCa sampler, and greedy LM
generation (counterpart of ``repro.serving.engine``).

Requests land in a ``Scheduler`` queue; batches are cut on
age/deadline pressure, policy-homogeneous by default
(``group_policies=False`` keeps mixed-policy cuts, served through a
``MixedBank``), and padded to power-of-two bucket sizes; each batch
runs the port's ``sample`` on the engine's device and every request
gets its own ``n_full_steps`` and, under an error-feedback policy, its
realized error and budget events.

The reference compiles one executable per (shape, lane-policy
signature, bucket) triple; the port runs eagerly, so ``warmup`` builds
the CUDA kernels and runs each warmed triple once, and the compile
accounting counts triples (see ``repro_torch.serving.metrics``).
CUDA-graph capture per signature comes later.

``execute_plan`` is shared with
``repro_torch.serving.async_engine.AsyncDiffusionEngine``, whose single
worker thread is then its only caller.

``LMEngine`` prefills a prompt through the decode step, one position at
a time, then generates greedily; its decode cache is updated in place
and made anew for each ``generate``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from repro_torch import device as device_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.core.policies import registry as policy_registry
from repro_torch.diffusion import sampler as sampler_lib
from repro_torch.diffusion import schedule
from repro_torch.models import blocks, transformer
from repro_torch.optim import adamw
from repro_torch.serving.metrics import ServeMetrics
from repro_torch.serving.scheduler import (BatchPlan, DiffusionRequest,
                                           Scheduler, bucket_sizes)

__all__ = ["DiffusionEngine", "DiffusionRequest", "DiffusionResult",
           "LMEngine"]


class DiffusionResult(NamedTuple):
    request_id: int
    latents: torch.Tensor
    n_full_steps: int        # THIS request's activated steps (per lane)
    wall_time_s: float
    queue_wait_s: float = 0.0
    bucket: int = 0
    # quality SLO report (error-feedback policies only): peak cache
    # error accumulated between full forwards, and how many fulls the
    # budget triggered for this request's lane
    realized_error: Optional[float] = None
    budget_events: Optional[int] = None


class DiffusionEngine:
    """Continuous-batching FreqCa-cached rectified-flow sampler.

    ``device`` defaults to ``cuda`` and raises when there is none;
    ``full_fn`` / ``from_crf_fn`` must compute on that device.
    """

    def __init__(self, full_fn: Callable, from_crf_fn: Callable,
                 latent_shape, crf_shape, policy,
                 n_steps: int = 50, max_batch: int = 8,
                 crf_dtype=torch.float32, max_wait_s: float = 0.0,
                 pad_to_max: bool = False, group_policies: bool = True,
                 shed_depth: Optional[int] = None,
                 shed_factor: float = 4.0, shapes: Sequence = (),
                 device=None):
        self.device = device_lib.resolve(device)
        self.full_fn = full_fn
        self.from_crf_fn = from_crf_fn
        self.latent_shape = tuple(latent_shape)      # [H, W, C]
        self.crf_shape = tuple(crf_shape)            # per-sample CRF [S, D]
        self.policy = policy
        self.n_steps = n_steps
        self.max_batch = max_batch
        self.crf_dtype = crf_dtype
        # multi-resolution shape ladder, shared by reference with the
        # scheduler so submit-time validation tracks declarations
        self.default_shape = (self.latent_shape, self.crf_shape)
        self.shapes: List = [self.default_shape]
        self._allowed_shapes = {self.default_shape}
        for pair in shapes:
            self.declare_shape(*pair)
        self.scheduler = Scheduler(max_batch=max_batch,
                                   max_wait_s=max_wait_s,
                                   pad_to_max=pad_to_max,
                                   group_policies=group_policies,
                                   default_policy=policy,
                                   shed_depth=shed_depth,
                                   shed_factor=shed_factor,
                                   default_shape=self.default_shape,
                                   allowed_shapes=self._allowed_shapes)
        self.metrics = ServeMetrics()
        self._ts = schedule.timesteps(n_steps, device=self.device)
        # (crf shape, lane-policy signature, bucket) triples run so far
        self._signatures: set = set()

    def declare_shape(self, latent_shape, crf_shape) -> tuple:
        """Add a (latent, CRF) shape pair to the deployment's ladder."""
        key = (tuple(latent_shape), tuple(crf_shape))
        if key not in self._allowed_shapes:
            self.shapes.append(key)
            self._allowed_shapes.add(key)
        return key

    @staticmethod
    def _shape_label(latent_shape, crf_shape) -> str:
        return ("lat" + "x".join(str(d) for d in latent_shape)
                + "/crf" + "x".join(str(d) for d in crf_shape))

    @property
    def buckets(self) -> List[int]:
        return bucket_sizes(self.max_batch)

    def state_bytes(self, batch: int = 1, latent_shape=None,
                    crf_shape=None) -> int:
        """Real cache-state footprint of the engine policy for a
        ``batch``-lane bucket, sized on the meta device (nothing is
        allocated)."""
        pol = policy_registry.resolve(self.policy)
        lat = tuple(latent_shape) if latent_shape else self.latent_shape
        crf = tuple(crf_shape) if crf_shape else self.crf_shape
        state = pol.init(batch, crf, self.crf_dtype, latent_shape=lat,
                         latent_dtype=torch.float32, device="meta")
        return pol.state_bytes(state)

    # --- signature accounting --------------------------------------------
    @staticmethod
    def _normalize_signature(lanes):
        """Collapse an all-equal lane assignment to the single policy so
        uniform batches of any composition share the per-bucket ladder."""
        lanes = tuple(lanes)
        if all(p == lanes[0] for p in lanes):
            return lanes[0]
        return lanes

    def metrics_dict(self) -> Dict:
        """Lossless ``ServeMetrics`` snapshot (plain Python values, safe
        to ship across a process boundary)."""
        return self.metrics.to_dict()

    def compiled_buckets(self) -> int:
        """Distinct (shape, lane-policy signature, bucket) triples run so
        far — the port's counterpart of the reference's jit-cache
        probe."""
        return len(self._signatures)

    def signature_budget(self, n_groups: int = 1) -> int:
        """Upper bound on signatures for steady-state traffic:
        ``shapes x groups x buckets``."""
        return len(self.shapes) * max(n_groups, 1) * len(self.buckets)

    def _run(self, x_init: torch.Tensor, sig, crf_feat):
        """Sample one batch under a lane-policy signature, recording the
        (shape, signature, bucket) triple as a hit or a miss."""
        triple = (tuple(crf_feat), sig, x_init.shape[0])
        self.metrics.observe_compile(hit=triple in self._signatures)
        self._signatures.add(triple)
        res = sampler_lib.sample(
            self.full_fn, self.from_crf_fn, x_init, self._ts, sig,
            crf_shape=(x_init.shape[0],) + tuple(crf_feat),
            crf_dtype=self.crf_dtype)
        self.metrics.observe_compiled_signatures(len(self._signatures))
        return res

    def warmup(self, buckets: Optional[Sequence[int]] = None,
               lane_policy_sets: Sequence[Sequence[object]] = (),
               policies: Sequence[object] = (),
               shapes: Sequence = ()) -> float:
        """Build the CUDA kernels (on a CUDA engine), then run every warmed
        signature once, with the reference's semantics: every bucket of
        the default policy (or ``buckets``), a full bucket ladder for each
        extra uniform policy in ``policies``, and each per-lane
        assignment in ``lane_policy_sets`` (its length must be a bucket
        size) — all of it at every declared shape, ``shapes`` adding
        (latent_shape, crf_shape) pairs to the ladder first.  The triple
        count is then at most ``signature_budget``.  Returns wall
        seconds."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from repro_torch.kernels import build
            build.build()
        for pair in shapes:
            self.declare_shape(*pair)
        for lat, crf in self.shapes:
            self.metrics.observe_state_bytes(
                self.state_bytes(batch=1, latent_shape=lat, crf_shape=crf),
                shape_key=self._shape_label(lat, crf))
        sigs = [(b, self.policy) for b in (buckets or self.buckets)]
        for pol in policies:
            sigs.extend((b, pol) for b in self.buckets
                        if pol != self.policy)
        for lanes in lane_policy_sets:
            lanes = tuple(lanes)
            if len(lanes) not in self.buckets:
                raise ValueError(f"lane policy set of length {len(lanes)} "
                                 f"matches no bucket in {self.buckets}")
            sigs.append((len(lanes), self._normalize_signature(lanes)))
        for lat, crf in self.shapes:
            for b, sig in sigs:
                x = torch.zeros((b,) + tuple(lat), device=self.device)
                self._run(x, sig, crf)
        self._sync()
        return time.perf_counter() - t0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- request path ----------------------------------------------------
    def submit(self, req: DiffusionRequest,
               now: Optional[float] = None) -> None:
        self.scheduler.submit(req, now=now)

    def build_x_init(self, plan: BatchPlan) -> torch.Tensor:
        """[bucket, H, W, C] float32 noise batch on the engine's device:
        each lane's noise from ``torch.Generator().manual_seed(seed)``
        (not JAX's bits), editing lanes partially noised, padded lanes
        zero."""
        lat = (tuple(plan.latent_shape) if plan.latent_shape is not None
               else self.latent_shape)
        lanes = []
        for r in plan.requests:
            gen = torch.Generator().manual_seed(r.seed)
            noise = torch.randn(lat, generator=gen, dtype=torch.float32)
            if r.init_latents is not None:
                ref = torch.as_tensor(r.init_latents, dtype=noise.dtype)
                noise = schedule.add_noise(ref.cpu(), noise,
                                           r.edit_strength)
            lanes.append(noise)
        lanes += [torch.zeros(lat)] * (plan.bucket - plan.n_real)
        return torch.stack(lanes).to(self.device)

    def execute_plan(self, plan: BatchPlan) -> List[DiffusionResult]:
        """Run one formed batch and build the per-request results.  The
        single execution path of the sync entry points (``run_batch``) and of
        ``AsyncDiffusionEngine``'s worker; one thread at a time."""
        sig = self._normalize_signature(plan.lane_policies(self.policy))
        crf = (tuple(plan.crf_shape) if plan.crf_shape is not None
               else self.crf_shape)
        lat = (tuple(plan.latent_shape) if plan.latent_shape is not None
               else self.latent_shape)
        x_init = self.build_x_init(plan)
        t0 = time.perf_counter()
        res = self._run(x_init, sig, crf)
        self._sync()
        wall = time.perf_counter() - t0
        n = plan.n_real
        lane_full = [int(v) for v in res.n_full_lanes[:n].tolist()]
        lane_err = lane_ev = None
        if res.feedback is not None:
            lane_err = [float(v) for v in res.feedback.realized[:n].tolist()]
            lane_ev = [int(v) for v in res.feedback.events[:n].tolist()]
        self.metrics.observe_batch(
            plan.bucket, n, wall, res.n_full, self.n_steps,
            lane_full=lane_full, group_key=plan.group_key,
            lane_errors=lane_err, lane_events=lane_ev,
            shape_key=self._shape_label(lat, crf))
        self.metrics.observe_shed_events(self.scheduler.shed_events)
        out = []
        for i, r in enumerate(plan.requests):   # padded lanes never leak
            err = lane_err[i] if lane_err is not None else None
            ev = lane_ev[i] if lane_ev is not None else None
            wait = max(0.0, plan.formed_at - r.submit_time)
            self.metrics.observe_request(wait, wait + wall,
                                         n_full=lane_full[i],
                                         realized_error=err,
                                         budget_events=ev)
            out.append(DiffusionResult(r.request_id, res.x[i], lane_full[i],
                                       wall, wait, plan.bucket,
                                       realized_error=err,
                                       budget_events=ev))
        return out

    # the reference's pre-async name
    _execute = execute_plan

    def run_batch(self, reqs: Optional[Sequence[DiffusionRequest]] = None,
                  flush: bool = True,
                  now: Optional[float] = None) -> List[DiffusionResult]:
        """Cut and serve one batch (``flush=True`` drains immediately)."""
        for r in (reqs or ()):
            self.submit(r, now=now)
        self.metrics.observe_queue_depth(self.scheduler.depth)
        plan = self.scheduler.form_batch(now=now, flush=flush)
        if plan is None:
            return []
        return self.execute_plan(plan)

    def serve_until_drained(self, flush: bool = True,
                            poll_s: float = 0.005) -> List[DiffusionResult]:
        out: List[DiffusionResult] = []
        while self.scheduler.depth:
            served = self.run_batch(flush=flush)
            out.extend(served)
            if not served:   # scheduler holding back: wait, don't spin
                time.sleep(poll_s)
        return out


class LMEngine:
    """Prefill + greedy decode for the assigned LM architectures.

    ``device`` resolves as everywhere in the port (default ``cuda``,
    raising without one); every parameter must already lie on it.  The
    window is ``window or cfg.sliding_window``; with one the KV caches
    are rings of that many slots, else of ``max_len``.  A prefix config
    serves text tokens (no prefix), as the reference's does; an enc-dec
    config raises ``NotImplementedError``: the reference's ``LMEngine``
    has no enc-dec form either (it decodes ``params["stack"]``).
    """

    def __init__(self, params, cfg: ModelConfig, max_len: int,
                 window: int = 0, device=None):
        self.device = device_lib.resolve(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        off = [tuple(p.shape) for p in adamw.leaves(params)
               if p.device != self.device]
        if off:
            raise ValueError(f"LMEngine on {self.device}: {len(off)} "
                             f"parameters lie elsewhere, e.g. {off[0]}")
        if cfg.is_encdec:
            raise NotImplementedError(
                f"LMEngine ({cfg.arch_id}): no enc-dec form, as in the "
                "reference; decode it with steps.make_decode_step and an "
                "encoder memory")
        self.params = params
        self.cfg = cfg
        self.max_len = max_len
        self.window = window or cfg.sliding_window
        self._cache_len = self.window if self.window > 0 else max_len
        self._dtype = getattr(torch, cfg.dtype)

    def new_cache(self, batch: int):
        return blocks.stack_cache_zeros(self.cfg, batch, self._cache_len,
                                        self._dtype, self.device)

    @torch.inference_mode()
    def prefill(self, prompt_tokens: torch.Tensor):
        """Run the decode step over every prompt position, filling a new
        cache.  Returns ``(logits [B, 1, V] of the last position in
        cfg.dtype, cache)``."""
        tokens = prompt_tokens.to(self.device, torch.int64)
        cache = self.new_cache(tokens.shape[0])
        logits = torch.zeros((tokens.shape[0], 1, self.cfg.vocab_size),
                             dtype=self._dtype, device=self.device)
        for i in range(tokens.shape[1]):
            out, cache = transformer.decode_step(
                self.params, tokens[:, i:i + 1], cache, self.cfg,
                window=self.window)
            logits = out.to(self._dtype)
        return logits, cache

    @torch.inference_mode()
    def generate(self, prompt_tokens: torch.Tensor, n_new: int):
        """prompt_tokens [B, P] -> [B, P + n_new] int64, the greedy
        continuation (argmax, its first maximum), picked on the device:
        no step reads a token back to the host."""
        logits, cache = self.prefill(prompt_tokens)
        toks = [prompt_tokens.to(self.device, torch.int64)]
        cur = torch.argmax(logits[:, -1:], dim=-1)
        for _ in range(n_new):
            toks.append(cur)
            logits, cache = transformer.decode_step(
                self.params, cur, cache, self.cfg, window=self.window)
            cur = torch.argmax(logits[:, -1:], dim=-1)
        return torch.cat(toks, dim=1)

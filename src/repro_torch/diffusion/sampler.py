"""Diffusion sampling loop, policy-agnostic with per-lane activation
(counterpart of ``repro.diffusion.sampler``).

The reference's ``lax.scan`` is a Python loop here and its ``lax.cond``
a host branch: each step the bank's ``decide`` returns a per-lane mask,
and one device-to-host read of it chooses between the full branch
(denoiser forward + cache update) and the cached branch (CRF prediction
+ final layer only).  With a lane-varying mask the forward runs when any
lane activates, and each lane's velocity is selected per lane, so a lane
behaves exactly as it would alone in the batch.

When some lane's policy consumes error feedback (``freqca_eb``), a full
step measures the prediction the cache would have served against the
fresh CRF (pre-update state), pushes the CRF, then feeds the
measurement back (``observe``), in the reference's order; the feedback
report is read off the final state once, after the loop.

The denoiser is abstract: ``full_fn(x, t) -> (velocity, crf)`` and
``from_crf_fn(crf, t) -> velocity``, with ``t`` a 0-d float32 tensor.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.policies import base as policy_base
from repro_torch.core.policies import registry as policy_registry

PolicyArg = Union[policy_base.Policy, Sequence[policy_base.Policy]]


class SampleResult(NamedTuple):
    x: torch.Tensor                        # final latents
    n_full: int                            # batch forwards (compute)
    n_full_lanes: Optional[torch.Tensor] = None   # [B] activated steps/lane
    trajectory: Optional[torch.Tensor] = None
    # [B]-shaped realized-error report when any lane's policy consumes
    # error feedback (freqca_eb), else None
    feedback: Optional[policy_base.ErrorFeedback] = None


def sample(full_fn: Callable, from_crf_fn: Callable, x_init: torch.Tensor,
           ts: torch.Tensor, policy: PolicyArg,
           crf_shape: Tuple[int, ...], crf_dtype=torch.float32,
           return_trajectory: bool = False) -> SampleResult:
    """Euler rectified-flow sampling from t=1 to t=0 under a cache policy.

    ts: [n_steps+1] decreasing times on x_init's device.  crf_shape:
    [B, *feat] shape of the CRF (sizes the cache state).
    """
    n_steps = ts.shape[0] - 1
    batch = x_init.shape[0]
    feat_shape = tuple(crf_shape[1:])
    bank = policy_registry.bank(policy, batch)
    state = bank.init(feat_shape, crf_dtype,
                      latent_shape=tuple(x_init.shape[1:]),
                      latent_dtype=x_init.dtype, device=x_init.device)
    x = x_init
    n_full = 0
    used = torch.zeros((batch,), dtype=torch.int64, device=x.device)
    traj = []
    for i in range(n_steps):
        t_now, t_next = ts[i], ts[i + 1]
        ctx = policy_base.StepContext(step_idx=i, t_now=t_now, x=x,
                                      batch=batch, feat_shape=feat_shape,
                                      crf_dtype=crf_dtype)
        state, mask = bank.decide(state, ctx)
        if bank.always_full:
            act = True
        else:   # the one device-to-host read of the step
            act = bool(mask[0] if bank.scalar_decision else mask.any())
        if act:
            v_full, crf = full_fn(x, t_now)
            if bank.uses_error_feedback:
                err = bank.measure_error(state, crf, ctx)
                state = bank.apply_update(state, crf, ctx, mask)
                state = bank.observe(state, err, ctx, mask)
            else:
                state = bank.apply_update(state, crf, ctx, mask)
            v = v_full
            if not bank.scalar_decision:
                # lanes that did not activate keep their own schedule
                v_hat = from_crf_fn(bank.predict(state, ctx), t_now)
                m = mask.reshape((batch,) + (1,) * (v_full.ndim - 1))
                v = torch.where(m, v_full, v_hat.to(v_full.dtype))
        else:
            v = from_crf_fn(bank.predict(state, ctx), t_now)
        x = x + (t_next - t_now).to(x.dtype) * v.to(x.dtype)
        n_full += int(act)
        used += mask.to(torch.int64)
        if return_trajectory:
            traj.append(x)
    return SampleResult(x=x, n_full=n_full, n_full_lanes=used,
                        trajectory=torch.stack(traj) if traj else None,
                        feedback=bank.error_feedback(state))


def reference_features(full_fn: Callable, x_init: torch.Tensor,
                       ts: torch.Tensor):
    """Run the uncached sampler and keep each step's output.

    Returns ``(x, xs [T, B, ...], crfs [T, B, S, D])``: the final
    latents, the latents after each of the T steps and the CRF of each
    step's forward.  The paper's Fig-2 frequency analysis and the Fig-4
    MSE ablation read these trajectories.
    """
    x = x_init
    xs, crfs = [], []
    for i in range(ts.shape[0] - 1):
        t_now, t_next = ts[i], ts[i + 1]
        v, crf = full_fn(x, t_now)
        x = x + (t_next - t_now).to(x.dtype) * v.to(x.dtype)
        xs.append(x)
        crfs.append(crf)
    return x, torch.stack(xs), torch.stack(crfs)

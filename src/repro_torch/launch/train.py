"""Training launcher (counterpart of ``repro.launch.train``).

``--arch dit-small`` (default) trains the DiT denoiser on the procedural
shapes dataset with the rectified-flow loss, AdamW and a warmup-cosine
schedule, then saves the parameters in the reference's checkpoint
format.  Any DiT config of the registry trains the same way; LM
training is not ported yet (``train_lm`` raises).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch dit-small \\
      --reduced --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch dit-small \\
      --steps 300 --ckpt results/dit_small    # on the card
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from repro_torch import configs as config_lib
from repro_torch import device as device_lib
from repro_torch.checkpointing import bridge, checkpoint
from repro_torch.configs.base import DiTConfig
from repro_torch.data import synthetic
from repro_torch.diffusion import training
from repro_torch.models import dit
from repro_torch.optim import adamw


def _mark(events: list, on_card: bool) -> None:
    """Record a CUDA event on the current stream (on the card only)."""
    if on_card:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()


def train_dit(cfg: DiTConfig, steps: int, batch: int, ckpt_dir: str,
              seed: int = 0, log_every: int = 20, size: int = 32,
              device=None, params=None,
              on_step: Optional[Callable] = None):
    """The reference's loop: AdamW(lr 2e-3, 50 warmup steps, cosine over
    ``steps``, weight decay 1e-4); step i draws a shapes batch at
    ``size`` and the loss's times and noise from one generator seeded
    ``seed·7919 + i``; the velocity is ``dit_forward`` with no text (so
    no double block and no ``text_proj`` runs, as in the reference).
    Starts from ``params`` if given (trained in place), else from
    ``dit.init_params(cfg, seed)``.  After step i, ``on_step(i, metrics,
    grads)`` sees the step's metrics — ``loss``, ``grad_norm``, ``lr``
    and, on the card, ``forward_ms``, ``backward_ms``, ``adamw_ms`` (CUDA
    events) and ``step_ms`` (host clock, data included) — and the
    gradient tree (``None`` for an unused leaf).  Each step reads its
    loss on the host, so each step ends in a synchronise.  Saves the
    parameters to ``ckpt_dir`` (if set) as ``dit_{steps:08d}`` in the
    reference's layout; returns them, no longer requiring grad."""
    dev = device_lib.resolve(device)
    if params is None:
        params = dit.init_params(cfg, seed=seed, device=dev)
    flat = adamw.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    opt_cfg = adamw.AdamWConfig(lr=2e-3, warmup_steps=50, total_steps=steps,
                                weight_decay=1e-4)
    opt_state = adamw.init(opt_cfg, params)

    def apply_fn(p, x_t, t):
        return dit.dit_forward(p, x_t, t, cfg).velocity

    on_card = dev.type == "cuda"
    t_start = time.time()
    for i in range(steps):
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(seed * 7919 + i)
        latents = synthetic.shapes_batch(gen, batch, size=size,
                                         channels=cfg.in_channels, device=dev)
        events = []
        _mark(events, on_card)
        loss, _ = training.rf_loss(apply_fn, params, {"latents": latents},
                                   gen)
        _mark(events, on_card)
        loss.backward()
        _mark(events, on_card)
        grads = adamw.tree_map(lambda p: p.grad, params)
        params, opt_state, om = adamw.update(opt_cfg, grads, opt_state,
                                             params)
        _mark(events, on_card)
        metrics = {"loss": float(loss.detach()),
                   "grad_norm": float(om["grad_norm"]), "lr": float(om["lr"])}
        if on_card:
            torch.cuda.synchronize(dev)
            for j, name in enumerate(("forward_ms", "backward_ms",
                                      "adamw_ms")):
                metrics[name] = events[j].elapsed_time(events[j + 1])
            metrics["step_ms"] = (time.perf_counter() - t0) * 1e3
        if on_step is not None:
            on_step(i, metrics, grads)
        del grads
        for p in flat:
            p.grad = None
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:5d} loss {metrics['loss']:.4f} "
                  f"grad_norm {metrics['grad_norm']:.3e} "
                  f"lr {metrics['lr']:.2e} ({time.time() - t_start:.1f}s)",
                  flush=True)
    for p in flat:
        p.requires_grad_(False)
    if ckpt_dir:
        checkpoint.save(ckpt_dir, steps, bridge.params_to_jax_numpy(params,
                                                                    cfg),
                        name="dit")
        print("saved", ckpt_dir, flush=True)
    return params


def train_lm(cfg, steps: int, batch: int, seq: int, ckpt_dir: str,
             seed: int = 0, log_every: int = 5):
    """Not ported yet: the LM-training slice (``ROADMAP.md`` §1) brings
    ``transformer.loss_fn``, ``chunked_cross_entropy`` and this loop,
    with a backward for the SSD scan."""
    raise NotImplementedError(
        f"train_lm ({cfg.arch_id}): LM training is not ported yet; it is "
        "the LM-training slice queued in ROADMAP.md §1")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="dit-small")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = config_lib.get_config(args.arch)
    if args.reduced:
        cfg = config_lib.reduced(cfg)
    if isinstance(cfg, DiTConfig):
        train_dit(cfg, args.steps, args.batch, args.ckpt, device=args.device)
    else:
        train_lm(cfg, args.steps, args.batch, args.seq, args.ckpt)


if __name__ == "__main__":
    main()

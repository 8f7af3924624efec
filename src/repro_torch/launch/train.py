"""Training launcher (counterpart of ``repro.launch.train``).

Two modes:
* ``--arch dit-small`` (default) trains the DiT denoiser on the
  procedural shapes dataset with the rectified-flow loss, AdamW and a
  warmup-cosine schedule (any DiT config of the registry trains the
  same way);
* ``--arch`` an LM of the registry (``yi-9b``, ``mamba2-370m``,
  ``granite-moe-3b-a800m``, ``seamless-m4t-medium``, ``llava-next-34b``,
  ...) trains the LM on the synthetic Markov token stream with the
  next-token loss (``train_lm``; enc-dec and prefix configs with random
  frames or prefix embeddings).
``--reduced`` takes the registry's reduced variant of the config (the
reference's ``reduced``: float32, d_model 128 in heads of 32, an SSM's
heads of 32 in chunks of 16; a DiT's d_model 64 in heads of 16).  It
runs where the full config runs, on the card by default or on the CPU
with ``--device cpu``: on the card an LM's attention takes the float32
flash kernels at head width 32 from 2048 tokens up, and an SSM layer the
SSD scan kernels at heads of 32 and chunks of 16.  Both save the
parameters in the reference's checkpoint format.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch dit-small \\
      --reduced --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \\
      --reduced --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \\
      --reduced --seq 2048 --steps 2    # on the card
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
from repro_torch.configs.base import DiTConfig, ModelConfig
from repro_torch.data import synthetic
from repro_torch.diffusion import training
from repro_torch.launch import steps as steps_lib
from repro_torch.models import common, dit
from repro_torch.optim import adamw


def _mark(events: list, on_card: bool) -> None:
    """Record a CUDA event on the current stream (on the card only)."""
    if on_card:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()


def _train(params, draw, loss_of, opt_cfg: adamw.AdamWConfig, steps: int,
           dev, on_step: Optional[Callable], log_every: int, log_line):
    """The loop both trainers share: per step i, ``batch = draw(i)``,
    ``loss_of(params, batch)`` (a 0-d loss tensor and a dict of 0-d
    metrics to log beside it), its backward and one AdamW update in
    place; the metrics ``loss``, ``grad_norm``, ``lr``, those of
    ``loss_of`` and, on the card, ``forward_ms``, ``backward_ms``,
    ``adamw_ms`` (CUDA events) and ``step_ms`` (host clock, data
    included) go to
    ``on_step(i, metrics, grads)`` with the gradient tree (``None`` for
    an unused leaf), and every ``log_every`` steps ``log_line(i,
    metrics, seconds so far)`` is printed.  Each step reads its loss on
    the host, so each step ends in a synchronise.  Returns the
    parameters, no longer requiring grad, and the per-step metrics."""
    flat = adamw.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    opt_state = adamw.init(opt_cfg, params)
    on_card = dev.type == "cuda"
    history = []
    t_start = time.time()
    for i in range(steps):
        t0 = time.perf_counter()
        batch = draw(i)
        events = []
        _mark(events, on_card)
        loss, extra = loss_of(params, batch)
        _mark(events, on_card)
        loss.backward()
        _mark(events, on_card)
        grads = adamw.tree_map(lambda p: p.grad, params)
        params, opt_state, om = adamw.update(opt_cfg, grads, opt_state,
                                             params)
        _mark(events, on_card)
        metrics = {"loss": float(loss.detach()),
                   "grad_norm": float(om["grad_norm"]), "lr": float(om["lr"]),
                   **{k: float(v) for k, v in extra.items()}}
        if on_card:
            torch.cuda.synchronize(dev)
            for j, name in enumerate(("forward_ms", "backward_ms",
                                      "adamw_ms")):
                metrics[name] = events[j].elapsed_time(events[j + 1])
            metrics["step_ms"] = (time.perf_counter() - t0) * 1e3
        history.append(metrics)
        if on_step is not None:
            on_step(i, metrics, grads)
        del grads, loss
        for p in flat:
            p.grad = None
        if i % log_every == 0 or i == steps - 1:
            print(log_line(i, metrics, time.time() - t_start), flush=True)
    for p in flat:
        p.requires_grad_(False)
    return params, history


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
    ``dit.init_params(cfg, seed)``.  ``on_step`` and the metrics as
    ``_train`` gives them.  Saves the parameters to ``ckpt_dir`` (if set)
    as ``dit_{steps:08d}`` in the reference's layout; returns them, no
    longer requiring grad."""
    dev = device_lib.resolve(device)
    if params is None:
        params = dit.init_params(cfg, seed=seed, device=dev)
    opt_cfg = adamw.AdamWConfig(lr=2e-3, warmup_steps=50, total_steps=steps,
                                weight_decay=1e-4)

    def draw(i):
        gen = torch.Generator(device=dev).manual_seed(seed * 7919 + i)
        return gen, synthetic.shapes_batch(gen, batch, size=size,
                                           channels=cfg.in_channels,
                                           device=dev)

    def loss_of(p, drawn):
        gen, latents = drawn
        return training.rf_loss(
            lambda q, x_t, t: dit.dit_forward(q, x_t, t, cfg).velocity, p,
            {"latents": latents}, gen)[0], {}

    params, _ = _train(
        params, draw, loss_of, opt_cfg, steps, dev, on_step, log_every,
        lambda i, m, sec: f"step {i:5d} loss {m['loss']:.4f} grad_norm "
                          f"{m['grad_norm']:.3e} lr {m['lr']:.2e} "
                          f"({sec:.1f}s)")
    if ckpt_dir:
        checkpoint.save(ckpt_dir, steps, bridge.params_to_jax_numpy(params,
                                                                    cfg),
                        name="dit")
        print("saved", ckpt_dir, flush=True)
    return params


def train_lm(cfg: ModelConfig, steps: int, batch: int, seq: int,
             ckpt_dir: str, seed: int = 0, log_every: int = 5, device=None,
             params=None, on_step: Optional[Callable] = None):
    """The reference's loop: AdamW(lr 1e-3, 10 warmup steps, cosine over
    ``steps``) on the config's ``loss_fn`` (``steps.loss_fn``: the stack
    rematerialised where ``cfg.remat``); step i draws ``lm_batch(batch,
    seq)`` from a generator seeded ``seed·104729 + i``, then, from the
    same generator, an enc-dec config's ``frames [batch, seq, d]`` and a
    prefix config's ``prefix_embeds [batch, n_prefix_tokens, d]``, each
    N(0, 0.1²) in float32 as the reference draws them.  Starts from
    ``params`` if given (trained in place), else from the config's specs
    drawn with ``seed``.  ``on_step`` and the metrics as ``_train`` gives
    them.  Saves the parameters to ``ckpt_dir`` (if set) as
    ``{cfg.arch_id}_{steps:08d}`` in the reference's layout; returns
    ``(params, losses)``, the parameters no longer requiring grad.
    With experts the loss holds the aux terms, and each step's metrics
    (and log line) add the stack's ``lb_loss`` and ``drop_fraction``."""
    dev = device_lib.resolve(device)
    if params is None:
        params = common.init_params(steps_lib.model_specs(cfg), seed=seed,
                                    device=dev,
                                    dtype=getattr(torch, cfg.dtype))
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps)
    loss_fn = steps_lib.loss_fn(cfg)

    def draw(i):
        gen = torch.Generator(device=dev).manual_seed(seed * 104729 + i)
        b = synthetic.lm_batch(gen, batch, seq, cfg.vocab_size, device=dev)
        extra = {"frames": (batch, seq)} if cfg.is_encdec else {}
        if cfg.n_prefix_tokens > 0:
            extra["prefix_embeds"] = (batch, cfg.n_prefix_tokens)
        for key, lead in extra.items():
            b[key] = torch.randn(lead + (cfg.d_model,), generator=gen,
                                 device=dev) * 0.1
        return b

    def loss_of(p, b):
        loss, metrics = loss_fn(p, b, cfg)
        return loss, ({k: metrics[k].detach()
                       for k in ("lb_loss", "drop_fraction")}
                      if cfg.moe is not None else {})

    def log_line(i, m, sec):
        return f"step {i:4d} loss {m['loss']:.4f}" + (
            f" lb_loss {m['lb_loss']:.4f} drop_fraction "
            f"{m['drop_fraction']:.4f}" if cfg.moe is not None else "")
    params, history = _train(params, draw, loss_of, opt_cfg, steps, dev,
                             on_step, log_every, log_line)
    if ckpt_dir:
        checkpoint.save(ckpt_dir, steps,
                        bridge.lm_params_to_jax_numpy(params, cfg),
                        name=cfg.arch_id)
        print("saved", ckpt_dir, flush=True)
    return params, [m["loss"] for m in history]


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
        train_lm(cfg, args.steps, args.batch, args.seq, args.ckpt,
                 device=args.device)


if __name__ == "__main__":
    main()

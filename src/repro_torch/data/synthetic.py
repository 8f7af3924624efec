"""Procedural synthetic datasets, no external data (counterpart of
``repro.data.synthetic``).

* ``shapes_batch`` — soft random ellipses / rectangles / stripes
  rendered into [B, H, W, C] "latents": low-frequency layout plus sharp
  high-frequency edges, the band structure FreqCa exploits.  Split into
  the draws (``shape_draws``, from a ``torch.Generator``) and the
  deterministic ``render_shapes``, so a test can render the reference's
  own draws.
* ``lm_batch`` — a mixture of Markov token streams: the draws, then the
  deterministic recurrence ``markov_tokens``.

The draws follow the reference's distributions, not its bits (the two
packages' random streams differ).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

_F32 = torch.float32


def shape_draws(generator: Optional[torch.Generator], batch: int,
                device=None) -> Dict[str, torch.Tensor]:
    """Per image ``[B, 1, 1]``: centre ``cx, cy`` ~ U(−0.5, 0.5), radii
    ``rx, ry`` ~ U(0.2, 0.6), ``kind`` in {0, 1, 2} (ellipse, rectangle,
    stripes), stripe ``phase`` ~ U(0, π)."""
    def uniform(lo, hi):
        u = torch.rand((batch, 1, 1), generator=generator, device=device)
        return lo + (hi - lo) * u
    out = {"cx": uniform(-0.5, 0.5), "cy": uniform(-0.5, 0.5),
           "rx": uniform(0.2, 0.6), "ry": uniform(0.2, 0.6)}
    out["kind"] = torch.randint(0, 3, (batch, 1, 1), generator=generator,
                                device=device)
    out["phase"] = uniform(0.0, math.pi)
    return out


def render_shapes(cx, cy, rx, ry, kind, phase, size: int = 32,
                  channels: int = 4) -> torch.Tensor:
    """The images of one batch of draws (each ``[B, 1, 1]``) ->
    ``[B, size, size, channels]`` float32 in ~[−1, 1]; channel c > 0 is
    the image rolled by 2c pixels along the width, scaled by 0.5^c."""
    dev = cx.device
    lin = torch.linspace(-1, 1, size, dtype=_F32, device=dev)
    yy, xx = torch.meshgrid(lin, lin, indexing="ij")
    d_ell = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2
    ellipse = torch.sigmoid((1.0 - d_ell) * 12.0)
    d_rect = torch.maximum(torch.abs(xx - cx) / rx, torch.abs(yy - cy) / ry)
    rect = torch.sigmoid((1.0 - d_rect) * 16.0)
    stripes = 0.5 + 0.5 * torch.sin(8.0 * (xx * torch.cos(phase)
                                           + yy * torch.sin(phase)))
    img = torch.where(kind == 0, ellipse,
                      torch.where(kind == 1, rect, stripes))
    img = img * 2.0 - 1.0
    chans = [img] + [torch.roll(img, shifts=c * 2, dims=-1) * (0.5 ** c)
                     for c in range(1, channels)]
    return torch.stack(chans, dim=-1)


def shapes_batch(generator: Optional[torch.Generator], batch: int,
                 size: int = 32, channels: int = 4,
                 device=None) -> torch.Tensor:
    """Random soft shapes, ``[B, size, size, C]`` float32 in ~[−1, 1]."""
    return render_shapes(**shape_draws(generator, batch, device), size=size,
                         channels=channels)


def markov_tokens(start: torch.Tensor, steps: torch.Tensor,
                  vocab: int) -> Dict[str, torch.Tensor]:
    """The token stream of ``start [B, 1]`` and ``steps [B, L]``:
    ``tok_i = (31·tok_{i−1} + steps_i) mod vocab`` from ``tok_{−1} =
    start``; labels are the next tokens, −1 past the end (int32)."""
    tok = start[:, 0].to(torch.int64)
    cols = []
    for i in range(steps.shape[1]):
        tok = (tok * 31 + steps[:, i].to(torch.int64)) % vocab
        cols.append(tok)
    tokens = torch.stack(cols, dim=1).to(torch.int32)
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)],
                       dim=1)
    return {"tokens": tokens, "labels": labels}


def lm_batch(generator: Optional[torch.Generator], batch: int, seq_len: int,
             vocab: int, device=None) -> Dict[str, torch.Tensor]:
    """Markov-chain token stream: ``start`` ~ U{0, vocab}, ``steps`` ~
    U{1, 7}; labels are next tokens."""
    start = torch.randint(0, vocab, (batch, 1), generator=generator,
                          device=device)
    steps = torch.randint(1, 7, (batch, seq_len), generator=generator,
                          device=device)
    return markov_tokens(start, steps, vocab)


def data_iterator(kind: str, batch: int, seed: int = 0, device=None, **kw):
    """Infinite iterator of batches: ``{"latents": ...}`` for ``kind ==
    "shapes"``, else ``lm_batch``'s; batch i draws from a generator
    seeded ``seed·100003 + i``, as the reference keys it."""
    i = 0
    while True:
        gen = torch.Generator(device=device or "cpu").manual_seed(
            seed * 100003 + i)
        if kind == "shapes":
            yield {"latents": shapes_batch(gen, batch, device=device, **kw)}
        else:
            yield lm_batch(gen, batch, device=device, **kw)
        i += 1

"""Architecture registry of the port: the DiT configs of this slice."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import dit_small, flux1_dev
from repro_torch.configs.base import DiTConfig

REGISTRY: Dict[str, DiTConfig] = {
    m.CONFIG.arch_id: m.CONFIG for m in (dit_small, flux1_dev)
}


def get_config(arch_id: str) -> DiTConfig:
    return REGISTRY[arch_id]


def reduced(cfg: DiTConfig) -> DiTConfig:
    """CPU-runnable smoke variant of the same family (2 layers,
    d_model 64) — the DiT branch of ``repro.configs.reduced``."""
    return dataclasses.replace(
        cfg, n_layers=2, n_double=min(cfg.n_double, 1), d_model=64,
        n_heads=4, d_ff=128, text_dim=min(cfg.text_dim, 32),
        n_text_tokens=min(cfg.n_text_tokens, 8), dtype="float32")

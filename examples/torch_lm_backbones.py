"""Assigned-architecture tour on the PyTorch port: a reduced variant of
every assigned architecture through three train steps and a short
greedy decode (the twin of ``examples/lm_backbones.py``).

  PYTHONPATH=src python examples/torch_lm_backbones.py
  PYTHONPATH=src python examples/torch_lm_backbones.py --device cpu
"""
import argparse

import torch

import repro_torch.configs as config_lib
from repro_torch import device as device_lib
from repro_torch.launch.train import train_lm
from repro_torch.serving.engine import LMEngine


def run(steps: int = 3, batch: int = 2, seq: int = 32,
        device=None) -> dict:
    """Per assigned architecture: ``train_lm`` on the reduced config,
    then, where the config has no prefix and is not enc-dec,
    ``LMEngine.generate`` of 6 tokens after a [1, 4] prompt (drawn on the
    host from seed 0 and moved).  Returns ``{arch: {"family", "losses",
    "params", "prompt", "tokens"}}`` (``tokens`` None where there is no
    decode)."""
    dev = device_lib.resolve(device)
    out = {}
    for arch in config_lib.ASSIGNED:
        cfg = config_lib.reduced(config_lib.get_config(arch))
        params, losses = train_lm(cfg, steps=steps, batch=batch, seq=seq,
                                  ckpt_dir="", device=dev)
        res = out[arch] = {"family": cfg.family, "losses": losses,
                           "params": params, "prompt": None, "tokens": None}
        if cfg.is_encdec or cfg.n_prefix_tokens:
            continue
        res["prompt"] = torch.randint(
            0, cfg.vocab_size, (1, 4),
            generator=torch.Generator().manual_seed(0)).to(dev)
        eng = LMEngine(params, cfg, max_len=16, device=dev)
        res["tokens"] = eng.generate(res["prompt"], n_new=6)[0].tolist()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    out = run(device=ap.parse_args(argv).device)
    for arch, res in out.items():
        losses = res["losses"]
        print(f"== {arch} ({res['family']}) ==")
        print(f"  {len(losses)} train steps, loss {losses[0]:.3f} -> "
              f"{losses[-1]:.3f}")
        if res["tokens"] is not None:
            print(f"  decode: {res['tokens']}")
    return out


if __name__ == "__main__":
    main()

"""Quickstart on the PyTorch port: train a small DiT on synthetic shapes,
then sample with FreqCa at 5x scheduled compute saving and compare with
the uncached output (the twin of ``examples/quickstart.py``).

Cache policies are self-contained objects from the registry
(``repro_torch.core.policies``): construct them directly and pass them
to the sampler.  Runs on the card by default; ``--device cpu`` runs the
plain PyTorch versions on the CPU instead.

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

import repro_torch.configs as config_lib
from repro_torch import device as device_lib
from repro_torch.core import policies
from repro_torch.diffusion import sampler, schedule
from repro_torch.launch.serve import dit_fns
from repro_torch.launch.train import train_dit


@torch.no_grad()
def sample(params, cfg, n_steps: int = 50, n_images: int = 4,
           size: int = 32, device=None) -> dict:
    """The sampling half: x0 drawn on the host from seed 0 and moved, so
    that every device samples the same bits."""
    dev = device_lib.resolve(device)
    x0 = torch.randn((n_images, size, size, cfg.in_channels),
                     generator=torch.Generator().manual_seed(0)).to(dev)
    ts = schedule.timesteps(n_steps, device=dev)
    crf_shape = (n_images, (size // cfg.patch_size) ** 2, cfg.d_model)
    full_fn, from_crf_fn = dit_fns(params, cfg)
    full = sampler.sample(full_fn, from_crf_fn, x0, ts,
                          policies.NoCachePolicy(), crf_shape=crf_shape)
    fast = sampler.sample(full_fn, from_crf_fn, x0, ts,
                          policies.FreqCaPolicy(interval=5, method="dct",
                                                rho=0.0625),
                          crf_shape=crf_shape)
    err = float(torch.linalg.norm(fast.x - full.x)
                / torch.linalg.norm(full.x))
    return {"n_steps": n_steps, "full_steps": full.n_full,
            "freqca_steps": fast.n_full,
            "saving": n_steps / fast.n_full, "rel_err": err,
            "x0": x0, "x_full": full.x, "x_freqca": fast.x}


def run(train_steps: int = 120, batch: int = 16, n_steps: int = 50,
        n_images: int = 4, size: int = 32, device=None) -> dict:
    """Train dit-small for ``train_steps`` on batches of ``batch`` at
    latent ``size``, then ``sample``; returns the printed numbers with
    the trained ``params`` and the latents."""
    dev = device_lib.resolve(device)
    cfg = config_lib.get_config("dit-small")
    params = train_dit(cfg, steps=train_steps, batch=batch, ckpt_dir="",
                       size=size, device=dev)
    out = sample(params, cfg, n_steps, n_images, size, dev)
    return dict(out, policies=policies.available(), params=params)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device_lib.resolve(args.device)
    print("registered cache policies:", ", ".join(policies.available()))
    res = run(device=args.device)
    print(f"uncached: {res['full_steps']} full steps; "
          f"freqca: {res['freqca_steps']} full steps "
          f"({res['saving']:.2f}x scheduled compute saving)")
    print(f"relative output error vs uncached: {res['rel_err']:.4f}")
    return res


if __name__ == "__main__":
    main()

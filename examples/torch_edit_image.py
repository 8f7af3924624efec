"""Image editing on the PyTorch port (FLUX.1-Kontext / Qwen-Image-Edit
regime): start from a partially-noised reference, denoise under FreqCa
with the FFT band split, measure fidelity against the uncached edit
(the twin of ``examples/edit_image.py``).

  PYTHONPATH=src python examples/torch_edit_image.py
  PYTHONPATH=src python examples/torch_edit_image.py --device cpu
"""
import argparse

import torch

import repro_torch.configs as config_lib
from repro_torch import device as device_lib
from repro_torch.core import policies
from repro_torch.data import synthetic
from repro_torch.diffusion import sampler, schedule
from repro_torch.launch.serve import dit_fns
from repro_torch.launch.train import train_dit

TAU = 0.6                                   # edit strength


@torch.no_grad()
def edit(params, cfg, n_steps: int = 50, n_images: int = 2, size: int = 32,
         device=None) -> dict:
    """The editing half: the reference images and their noise drawn on
    the host (seeds 3 and 4) and moved, noised to ``TAU``, then denoised
    from t = ``TAU`` uncached and under FreqCa."""
    dev = device_lib.resolve(device)
    ref = synthetic.shapes_batch(torch.Generator().manual_seed(3), n_images,
                                 size=size, channels=cfg.in_channels)
    noise = torch.randn(ref.shape, generator=torch.Generator().manual_seed(4))
    x0 = schedule.add_noise(ref, noise, TAU).to(dev)
    ts = schedule.timesteps(n_steps, device=dev) * TAU   # resume at TAU
    crf_shape = (n_images, (size // cfg.patch_size) ** 2, cfg.d_model)
    full_fn, from_crf_fn = dit_fns(params, cfg)
    full = sampler.sample(full_fn, from_crf_fn, x0, ts,
                          policies.NoCachePolicy(), crf_shape=crf_shape)
    fast = sampler.sample(full_fn, from_crf_fn, x0, ts,
                          policies.FreqCaPolicy(interval=5, method="fft"),
                          crf_shape=crf_shape)
    err = float(torch.linalg.norm(fast.x - full.x)
                / torch.linalg.norm(full.x))
    return {"n_steps": n_steps, "full_steps": full.n_full,
            "freqca_steps": fast.n_full, "rel_err": err, "x0": x0,
            "x_full": full.x, "x_freqca": fast.x}


def run(train_steps: int = 120, batch: int = 16, n_steps: int = 50,
        n_images: int = 2, size: int = 32, device=None) -> dict:
    """Train dit-small as the quickstart does, then ``edit``; returns the
    printed numbers with the trained ``params`` and the latents."""
    dev = device_lib.resolve(device)
    cfg = config_lib.get_config("dit-small")
    params = train_dit(cfg, steps=train_steps, batch=batch, ckpt_dir="",
                       size=size, device=dev)
    return dict(edit(params, cfg, n_steps, n_images, size, device=dev),
                params=params)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = run(device=args.device)
    print(f"edit with freqca: {res['freqca_steps']}/{res['n_steps']} full "
          f"steps, rel err vs uncached edit {res['rel_err']:.4f}")
    return res


if __name__ == "__main__":
    main()

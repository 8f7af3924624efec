"""The paper's Fig-2 frequency analysis on the PyTorch port, on the bench
DiT: low band = similar but jumpy; high band = less similar but
continuous (the twin of ``examples/freq_analysis.py``, with the
arithmetic of ``benchmarks/fig2_freq_analysis.py``).

(a)-(b) temporal cosine similarity of the low and high bands across
step intervals; (c)-(d) a trajectory continuity proxy, the relative
magnitude of the second temporal difference (low = smooth).  The
paper's claims:
  * low band:  HIGH similarity, POOR continuity (jumps),
  * high band: LOWER similarity, GOOD continuity (predictable).

The bench DiT is dit-small trained 200 steps at latent 32 on batches of
16, or restored from the reference's checkpoint directory
(``results/bench_ckpt``) where that holds a ``dit`` step.  The rows go
to ``results/torch/fig2.json``.

  PYTHONPATH=src python examples/torch_freq_analysis.py
  PYTHONPATH=src python examples/torch_freq_analysis.py --device cpu
"""
import argparse
import json
import os

import torch

import repro_torch.configs as config_lib
from repro_torch import device as device_lib
from repro_torch.checkpointing import bridge, checkpoint
from repro_torch.core import frequency
from repro_torch.diffusion import sampler, schedule
from repro_torch.launch.serve import dit_fns
from repro_torch.launch.train import train_dit

INTERVALS = (1, 2, 4, 8)
BANDS = [(method, rho) for method in ("dct", "fft") for rho in (0.0625, 0.25)]


def band_series(crfs: torch.Tensor, rho: float, method: str):
    """Each step's CRF ``[T, B, S, D]`` split into ``(lows, highs)``."""
    lows, highs = [], []
    for i in range(crfs.shape[0]):
        b = frequency.decompose(crfs[i], rho, method)
        lows.append(b.low)
        highs.append(b.high)
    return torch.stack(lows), torch.stack(highs)


def similarity_at_intervals(series: torch.Tensor, intervals) -> dict:
    out = {}
    t = series.shape[0]
    for k in intervals:
        sims = [float(frequency.cosine_similarity(series[i], series[i + k]))
                for i in range(0, t - k, max(1, (t - k) // 8))]
        out[k] = sum(sims) / len(sims)
    return out


def continuity(series: torch.Tensor) -> float:
    """||second difference|| / ||first difference||: lower = smoother
    (more continuous, easier to extrapolate)."""
    d1 = series[1:] - series[:-1]
    d2 = series[2:] - 2 * series[1:-1] + series[:-2]
    n1 = float(torch.linalg.norm(d1.to(torch.float32)))
    n2 = float(torch.linalg.norm(d2.to(torch.float32)))
    return n2 / max(n1, 1e-9)


def get_model(train_steps: int = 200, size: int = 32,
              ckpt_dir: str = "results/bench_ckpt", device=None):
    """The bench DiT: restored from ``ckpt_dir``'s latest ``dit`` step,
    else trained (batch 16) and not saved."""
    dev = device_lib.resolve(device)
    cfg = config_lib.get_config("dit-small")
    step = checkpoint.latest_step(ckpt_dir, "dit")
    if step >= 0:
        return cfg, bridge.params_from_checkpoint(ckpt_dir, step, cfg,
                                                  device=dev)
    return cfg, train_dit(cfg, train_steps, 16, ckpt_dir="", size=size,
                          device=dev)


def fig2(crfs: torch.Tensor) -> dict:
    """Fig 2's statistics of one CRF trajectory: per (method, rho), each
    band's mean similarity at ``INTERVALS`` and its continuity ratio,
    unrounded."""
    out = {}
    for method, rho in BANDS:
        low, high = band_series(crfs, rho, method)
        out[method, rho] = {
            "sim_low": similarity_at_intervals(low, INTERVALS),
            "sim_high": similarity_at_intervals(high, INTERVALS),
            "c_low": continuity(low), "c_high": continuity(high)}
    return out


def claims(stats: dict) -> dict:
    """The paper-consistent claims that hold at bench scale, per (method,
    rho): (i) the low band stays highly similar at every interval; (ii)
    high-band similarity decays faster with the interval; (iii) the high
    band is smoother along the trajectory."""
    out = {}
    for key, s in stats.items():
        sim_low, sim_high = s["sim_low"], s["sim_high"]
        out[key] = {
            "low_similar": min(sim_low.values()) > 0.9,
            "high_decays_faster": (sim_high[1] - sim_high[8]
                                   > sim_low[1] - sim_low[8]),
            "high_smoother": s["c_high"] < s["c_low"]}
    return out


def table(stats: dict) -> list:
    """The reference's rows, rounded to 4 places."""
    rows = []
    for (method, rho), s in stats.items():
        for k in INTERVALS:
            rows.append({"method": method, "rho": rho, "interval": k,
                         "cos_sim_low": round(s["sim_low"][k], 4),
                         "cos_sim_high": round(s["sim_high"][k], 4)})
        rows.append({"method": method, "rho": rho,
                     "interval": "2nd-diff ratio",
                     "cos_sim_low": round(s["c_low"], 4),
                     "cos_sim_high": round(s["c_high"], 4)})
    return rows


@torch.no_grad()
def trajectory(params, cfg, n_steps: int = 50, n_images: int = 2,
               size: int = 32, device=None) -> torch.Tensor:
    """The CRFs ``[n_steps, n_images, S, D]`` of the uncached sampler's
    steps from x0 drawn on the host from seed 3 and moved."""
    dev = device_lib.resolve(device)
    full_fn, _ = dit_fns(params, cfg)
    x0 = torch.randn((n_images, size, size, cfg.in_channels),
                     generator=torch.Generator().manual_seed(3)).to(dev)
    _, _, crfs = sampler.reference_features(
        full_fn, x0, schedule.timesteps(n_steps, device=dev))
    return crfs


def run(out: str = "results/torch/fig2.json", train_steps: int = 200,
        size: int = 32, n_steps: int = 50, n_images: int = 2,
        ckpt_dir: str = "results/bench_ckpt", device=None) -> dict:
    """The bench DiT's ``trajectory``, its Fig-2 statistics, rows and
    claims; the rows are written to ``out``."""
    dev = device_lib.resolve(device)
    cfg, params = get_model(train_steps, size, ckpt_dir, dev)
    crfs = trajectory(params, cfg, n_steps, n_images, size, dev)
    with torch.no_grad():
        stats = fig2(crfs)
    rows = table(stats)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    return {"stats": stats, "rows": rows, "claims": claims(stats),
            "crfs": crfs, "params": params}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = run(device=args.device)
    rows = res["rows"]
    cols = list(rows[0])
    print("\n### Fig 2 — band similarity & continuity "
          "(low: similar but jumpy; high: continuous)")
    print(" | ".join(cols))
    print(" | ".join(["---"] * len(cols)))
    for r in rows:
        print(" | ".join(str(r[c]) for c in cols))
    for key, held in res["claims"].items():
        assert all(held.values()), (key, held, res["stats"][key])
    return res


if __name__ == "__main__":
    main()

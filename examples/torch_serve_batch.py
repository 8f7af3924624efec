"""End-to-end serving driver on the PyTorch port (the paper's deployment
shape; the twin of ``examples/serve_batch.py``): a mixed-size stream of
generation + editing requests through the continuous-batching FreqCa
``DiffusionEngine``, per-bucket warmed signatures, age-based batch
formation, metrics report.

Requests carry per-request cache policies (freqca / fora / freqca_a
cycling), arrivals follow an open-loop Poisson process, and the client
is four real threads submitting through ``AsyncDiffusionEngine``.

  PYTHONPATH=src python examples/torch_serve_batch.py
  PYTHONPATH=src python examples/torch_serve_batch.py --device cpu
"""
import argparse

from repro_torch.launch import serve


def arguments(requests: int = 16, interval: int = 5, steps: int = 50,
              train_steps: int = 120, batch: int = 8, edit_every: int = 5,
              rate: float = 2.0, clients: int = 4) -> list:
    """The launcher's argument list; the defaults are the reference
    script's."""
    return ["--requests", str(requests), "--interval", str(interval),
            "--steps", str(steps), "--train-steps", str(train_steps),
            "--batch", str(batch), "--edit-every", str(edit_every),
            "--mixed-policies", "--arrival", "poisson", "--rate", str(rate),
            "--clients", str(clients)]


def run(device=None, **sizes) -> dict:
    """``repro_torch.launch.serve.main`` on ``arguments(**sizes)``, on
    ``device`` (default the card); returns what it served."""
    return serve.main(arguments(**sizes)
                      + ([] if device is None else ["--device", str(device)]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()

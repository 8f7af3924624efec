"""The port's invariant linter and runtime sanitizers (counterpart of
``repro.analysis``).

* Static linter (``python -m repro_torch.analysis``, AST-based, stdlib
  only): ``env-read-at-import`` (:mod:`.recompile`), ``lock-order`` and
  ``future-guard`` (:mod:`.locks`), with the reference's suppression
  syntax ``# repro: allow[rule]: why`` (:mod:`.core`).  The reference's
  JAX-only rules (``unhashable-static-arg``, ``traced-branch``,
  ``donated-reuse``) are left out.
* Runtime lock-order sanitizer (:mod:`.runtime`, armed by
  ``REPRO_SANITIZE=1``) and its graph helpers (:mod:`.graphs`); the
  tracer-leak check is JAX-only and is not ported.

The serving stack imports :mod:`.runtime` on every engine construction,
so this ``__init__`` loads the linter (which pulls in :mod:`ast`) only
when one of its names is asked for.
"""
from __future__ import annotations

__all__ = ["analyze_paths", "Finding"]


def __getattr__(name: str):
    if name in __all__:
        from repro_torch.analysis import core
        return getattr(core, name)
    raise AttributeError(name)

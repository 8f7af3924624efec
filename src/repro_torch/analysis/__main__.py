"""CLI: ``python -m repro_torch.analysis [--ci] [--rules] [paths...]``
(counterpart of ``python -m repro.analysis``).

Stdlib only (the repo's own AST passes; neither torch nor jax is
imported).  Run from the repository root, it lints the port by default:
``src/repro_torch``, ``chip_smoke.py`` and ``tests/test_torch_*.py``.

Exit status: 0 = clean, 1 = findings, 2 = bad invocation.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis.core import RULES, analyze_paths, summarize

_CI_PATHS = ("src/repro_torch", "chip_smoke.py", "tests/test_torch_*.py")


def _default_paths():
    """The port's files under the current directory (globs expanded)."""
    out = []
    for pattern in _CI_PATHS:
        hits = sorted(Path().glob(pattern))
        out.extend(hits or [Path(pattern)])
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-aware invariant linter for the port "
                    "(import-time env reads, lock discipline)")
    parser.add_argument(
        "paths", nargs="*", type=Path,
        help="files or directories to lint (default: %s)"
             % " ".join(_CI_PATHS))
    parser.add_argument(
        "--ci", action="store_true",
        help="CI mode: keep output terse")
    parser.add_argument(
        "--rules", action="store_true",
        help="list the known rule names and exit")
    args = parser.parse_args(argv)

    if args.rules:
        print("\n".join(RULES))
        return 0

    paths = args.paths or _default_paths()
    missing = [p for p in paths if not p.exists()]
    if missing:
        print("no such path: %s" % ", ".join(map(str, missing)),
              file=sys.stderr)
        return 2

    findings = analyze_paths(paths, root=Path.cwd())
    for f in findings:
        print(f)
    if findings:
        print(summarize(findings), file=sys.stderr)
        return 1
    if not args.ci:
        n = len(list(paths))
        print(f"repro_torch.analysis: clean ({n} root(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())

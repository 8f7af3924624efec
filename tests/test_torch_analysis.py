"""The port's invariant linter (``repro_torch.analysis``) against the
reference's (``repro.analysis``): the shared rules' cases of
``tests/test_analysis.py`` (env reads at import, lock order, the future
guard, suppressions, parse errors, the CLI's exit codes), both linters'
findings on the same fixture files for the rules they share, the
JAX-only rules left out, and the port lints clean.  Exact comparisons
throughout (findings are discrete)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis.core import analyze_paths as ref_analyze
from repro_torch.analysis.core import RULES, analyze_paths

REPO = Path(__file__).resolve().parent.parent
SHARED = {"env-read-at-import", "lock-order", "future-guard",
          "bad-suppression", "parse-error"}


def lint(tmp_path, source, name="snippet.py"):
    """Lint one snippet with the port's linter: [(rule, line)]."""
    f = tmp_path / name
    f.write_text(source)
    return [(x.rule, x.line) for x in analyze_paths([f], root=tmp_path)]


def rules(findings):
    return {r for r, _ in findings}


ENV_BAD = ("import os\n"
           "MODE = os.environ.get('REPRO_MODE', 'x')\n"
           "SIZE = int(os.getenv('SIZE', '1'))\n"
           "RAW = os.environ['HOME']\n")
ENV_OK = ("import os\n"
          "def mode():\n"
          "    return os.environ.get('M', 'x')\n"
          "def __getattr__(name):\n"
          "    return os.environ.get(name, '')\n"
          "os.environ.setdefault('OMP_NUM_THREADS', '1')\n"
          "os.environ['XLA_FLAGS'] = ('--foo ' \n"
          "    + os.environ.get('XLA_FLAGS', ''))\n")
LOCK_CYCLE = (
    "import threading\n"
    "class A:\n"
    "    def __init__(self):\n"
    "        self.l1 = threading.Lock()\n"
    "class B:\n"
    "    def __init__(self, a: A):\n"
    "        self.a = a\n"
    "        self.l2 = threading.Lock()\n"
    "    def fwd(self):\n"
    "        with self.l2:\n"
    "            with self.a.l1:\n"
    "                pass\n"
    "    def rev(self):\n"
    "        with self.a.l1:\n"
    "            with self.l2:\n"
    "                pass\n")
LOCK_THROUGH_CALLS = (
    "import threading\n"
    "class A:\n"
    "    def __init__(self):\n"
    "        self.l1 = threading.Lock()\n"
    "    def take(self):\n"
    "        with self.l1:\n"
    "            pass\n"
    "class B:\n"
    "    def __init__(self, a: A):\n"
    "        self.a = a\n"
    "        self.l2 = threading.Lock()\n"
    "    def grab(self):\n"
    "        with self.l2:\n"
    "            pass\n"
    "    def fwd(self):\n"
    "        with self.l2:\n"
    "            self.a.take()\n"
    "    def rev(self):\n"
    "        with self.a.l1:\n"
    "            self.grab()\n")
CONDITION = ("import threading\n"
             "class R:\n"
             "    def __init__(self):\n"
             "        self.lk = threading.Lock()\n"
             "        self.cv = threading.Condition(self.lk)\n"
             "    def f(self):\n"
             "        with self.cv:\n"
             "            with self.lk:\n"
             "                pass\n")
FUTURE_BAD = ("def resolve(fut, res):\n"
              "    fut.set_result(res)\n"
              "def fail(fut, e):\n"
              "    fut.set_exception(e)\n")
FUTURE_OK = ("from concurrent.futures import InvalidStateError\n"
             "def resolve(fut, res, counters):\n"
             "    try:\n"
             "        fut.set_result(res)\n"
             "    except InvalidStateError:\n"
             "        counters['duplicate_results'] += 1\n"
             "def fail(fut, e):\n"
             "    if fut is not None and not fut.done():\n"
             "        fut.set_exception(e)\n"
             "def start(fut, res):\n"
             "    if fut.set_running_or_notify_cancel():\n"
             "        fut.set_result(res)\n")
SUPPRESSED = ("import os\n"
              "# repro: allow[env-read-at-import]: frozen on purpose, "
              "build id\n"
              "BUILD = os.environ.get('BUILD_ID', '')\n")
SAME_LINE = ("import os\n"
             "B = os.environ.get('B', '')"
             "  # repro: allow[env-read-at-import]: frozen on purpose\n")
BARE = ("import os\n"
        "# repro: allow[env-read-at-import]\n"
        "BUILD = os.environ.get('BUILD_ID', '')\n")
UNKNOWN = "x = 1  # repro: allow[no-such-rule]: whatever\n"
WRONG_RULE = ("import os\n"
              "# repro: allow[lock-order]: wrong rule name for this line\n"
              "BUILD = os.environ.get('BUILD_ID', '')\n")
PARSE_ERROR = "def broken(:\n"

# (source, expected [(rule, line)] or a set of rules)
CASES = {
    "env_read_fires": (ENV_BAD, [("env-read-at-import", 2),
                                 ("env-read-at-import", 3),
                                 ("env-read-at-import", 4)]),
    "env_read_sanctioned_silent": (ENV_OK, []),
    "env_read_in_class_body": ("import os\nclass C:\n"
                               "    FLAG = os.environ.get('F', '')\n",
                               {"env-read-at-import"}),
    "lock_inversion_fires": (LOCK_CYCLE, {"lock-order"}),
    "lock_consistent_silent": (LOCK_CYCLE.replace(
        "    def rev(self):\n        with self.a.l1:\n"
        "            with self.l2:\n",
        "    def rev(self):\n        with self.l2:\n"
        "            with self.a.l1:\n"), []),
    "lock_through_calls": (LOCK_THROUGH_CALLS, {"lock-order"}),
    "condition_aliases_its_lock": (CONDITION, []),
    "future_guard_fires": (FUTURE_BAD, {"future-guard"}),
    "future_guard_sanctioned_silent": (FUTURE_OK, []),
    "suppression_silences": (SUPPRESSED, []),
    "suppression_same_line": (SAME_LINE, []),
    "bare_suppression_flagged": (BARE, [("bad-suppression", 2)]),
    "unknown_rule_flagged": (UNKNOWN, [("bad-suppression", 1)]),
    "suppression_does_not_leak": (WRONG_RULE, {"env-read-at-import"}),
    "parse_error_reported": (PARSE_ERROR, [("parse-error", 1)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_cases(tmp_path, case):
    source, want = CASES[case]
    found = lint(tmp_path, source)
    if isinstance(want, set):
        assert rules(found) == want
    else:
        assert found == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_findings_as_the_reference(tmp_path, case):
    """Both linters report the same (path, line, rule) on each fixture
    for the rules they share (the reference's bad-suppression message
    lists more rule names, so messages are not compared)."""
    f = tmp_path / "snippet.py"
    f.write_text(CASES[case][0])
    mine = [(x.path, x.line, x.rule) for x in analyze_paths([f], tmp_path)]
    ref = [(x.path, x.line, x.rule) for x in ref_analyze([f], tmp_path)
           if x.rule in SHARED]
    assert mine == ref


def test_same_findings_on_the_port_sources():
    """Both linters run over the port's own files agree (no finding)."""
    paths = ([REPO / "src" / "repro_torch", REPO / "chip_smoke.py"]
             + sorted((REPO / "tests").glob("test_torch_*.py")))
    mine = [(x.path, x.line, x.rule) for x in analyze_paths(paths, REPO)]
    ref = [(x.path, x.line, x.rule) for x in ref_analyze(paths, REPO)
           if x.rule in SHARED]
    assert mine == ref == []


def test_jax_only_rules_are_left_out(tmp_path):
    """The port lists only the rules it checks; a jit-static, a traced
    branch and a donated reuse fire in the reference and not here, and a
    suppression naming one of those rules is unknown to the port."""
    assert set(RULES) == SHARED
    source = ("import jax\n"
              "step = jax.jit(lambda x: x + 1, donate_argnums=0)\n"
              "def use(x):\n"
              "    y = step(x)\n"
              "    return x + y\n"
              "class Pol:\n"
              "    def decide(self, step, t):\n"
              "        if step > 3:\n"
              "            return 1.0\n"
              "        return float(t)\n")
    f = tmp_path / "jaxy.py"
    f.write_text(source)
    assert {x.rule for x in ref_analyze([f], tmp_path)} == {
        "donated-reuse", "traced-branch"}
    assert analyze_paths([f], tmp_path) == []
    assert lint(tmp_path, "x = 1  # repro: allow[traced-branch]: jit\n") \
        == [("bad-suppression", 1)]


def test_the_port_lints_clean():
    """The port's own files (``python -m repro_torch.analysis``'s
    default paths) have no finding."""
    paths = ([REPO / "src" / "repro_torch", REPO / "chip_smoke.py"]
             + sorted((REPO / "tests").glob("test_torch_*.py")))
    findings = analyze_paths(paths, root=REPO)
    assert findings == [], "\n".join(str(f) for f in findings)


def _cli(*args, cwd=REPO):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], capture_output=True, text=True, env=env,
                          cwd=cwd, timeout=120)


def test_cli_exit_codes(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nM = os.environ.get('M', '')\n")
    r = _cli(str(bad))
    assert r.returncode == 1
    assert "env-read-at-import" in r.stdout
    r = _cli("--rules")
    assert r.returncode == 0
    assert r.stdout.split() == list(RULES)
    assert _cli(str(tmp_path / "missing.py")).returncode == 2
    r = _cli()                    # the port's default paths, from the root
    assert r.returncode == 0, r.stdout + r.stderr
    assert "clean" in r.stdout

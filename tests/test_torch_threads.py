"""The port's CPU tests run torch on one intra-op thread.

torch sizes its intra-op pool to the machine's cores in every process,
so the tier-1 run's pytest-xdist workers (``-n 6``) run six such pools
on the same cores; their OpenMP threads spin while they wait, and the
port's many small float32 ops then take tens of times their time alone
(``train_lm``'s 150 steps in ``test_torch_lm_training.py``: 8 s alone,
491 s in a 6-worker run on 8 cores; the port's test files together 823 s
that way, 289 s with this file).  Every worker imports every test file
while it collects, before any test runs, so setting the pool here sets
it for each worker's whole session (torch gives a thread it starts
later the same setting); a single-process run takes it too.  JAX's and
numpy's thread pools are left as they are.
"""
import torch

torch.set_num_threads(1)


def test_torch_runs_one_intra_op_thread():
    assert torch.get_num_threads() == 1

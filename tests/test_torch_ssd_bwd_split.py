"""The SSD-scan backward kernel's decomposition, on the CPU: its bf16
products (``ref.bf16_split_matmul``: a float32 operand split into bf16
hi + lo, hi·hi + hi·lo + lo·hi) and the kernel's passes written out in
plain PyTorch (``ref.ssd_chunk_scan_bwd_split_ref``: Z summed over the
heads before its [Q, N] products), held against the exact plain
version ``ref.ssd_chunk_scan_bwd_ref`` and against ``jax.vjp`` of the
reference's ``repro.models.ssm.ssd_chunked``.

Tolerances are the card's, as max |got − want| / max |want| per output
(``chip_smoke.SSD_BWD_TOL`` and ``TOLERANCE``, the hopper tests'
``_card_tol``): dx, dB and dC 1e-4 in float32 and 2e-2 in bf16 (one
rounding of the output), ddt 1e-4 and dA 1e-3 in both.  A split operand
keeps ~16 significant bits (2^-18 relative), so the split products sit
well inside them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels import ref
from test_torch_ssd_bwd import _card_tol

NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _inputs(b, s, h, n, seed, dt_scale=1.0):
    """The card tests' draw (``test_torch_ssd_bwd._card_inputs``: dt =
    softplus(N(0, 1) − 2)·scale, x, B, C at 0.5), made with numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, 64)) * 0.5).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)) - 2.0))
          * dt_scale).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    dy = rng.standard_normal((b, s, h, 64)).astype(np.float32)
    return x, dt, a, bm, cm, dy


def _close(got, want, tol):
    errs = {}
    for name, g, w in zip(NAMES, got, want, strict=True):
        g, w = (np.asarray(v.double() if isinstance(v, torch.Tensor) else v,
                           np.float64) for v in (g, w))
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        errs[name] = np.abs(g - w).max() / np.abs(w).max()
    assert all(errs[k] <= tol[k] for k in NAMES), errs
    return errs


@pytest.mark.parametrize("m,k,n", [(16, 64, 8), (64, 256, 64)])
@pytest.mark.parametrize("a_bf16,b_bf16", [(False, False), (False, True),
                                           (True, False), (True, True)])
def test_split_matmul_precision(m, k, n, a_bf16, b_bf16):
    """A bf16 operand is exact; a split float32 one keeps ~2^-16 of each
    term; without its lo plane the product would keep only bf16's 2^-8."""
    rng = np.random.default_rng(k + 2 * a_bf16 + b_bf16)
    a = torch.from_numpy(rng.standard_normal((3, m, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, k, n)).astype(np.float32))
    if a_bf16:
        a = a.to(torch.bfloat16)
    if b_bf16:
        b = b.to(torch.bfloat16)
    want = a.double() @ b.double()
    scale = (a.double().abs() @ b.double().abs()).max()
    err = ((ref.bf16_split_matmul(a, b).double() - want).abs().max()
           / scale).item()
    assert err <= (1e-6 if a_bf16 and b_bf16 else 2e-5), err
    if not (a_bf16 and b_bf16):
        hi_only = (a.to(torch.bfloat16).double() @ b.to(torch.bfloat16)
                   .double())
        assert ((hi_only - want).abs().max() / scale).item() > 10 * err


def test_split_matmul_planes():
    """hi is bf16's round to nearest; lo the rounded remainder; a bf16
    tensor has no lo plane."""
    v = torch.tensor([1.0 + 2 ** -9 + 2 ** -20, -3.0e-5, 7.0])
    hi, lo = ref._bf16_planes(v)
    assert torch.equal(hi, v.to(torch.bfloat16).float())
    assert torch.equal(lo, (v - hi).to(torch.bfloat16).float())
    assert ((hi + lo - v).abs() <= v.abs() * 2 ** -16).all()
    hi, lo = ref._bf16_planes(v.to(torch.bfloat16))
    assert lo is None and torch.equal(hi, v.to(torch.bfloat16).float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,n,chunk,dt_scale", [
    (1, 128, 2, 16, 64, 1.0),       # the smallest chunk and state
    (2, 512, 3, 128, 256, 1.0),
    (2, 384, 3, 24, 128, 1.0),      # N 24 (the kernel pads it to 128)
    (1, 1024, 2, 32, 128, 20.0),    # decays clipped at −60
    (1, 768, 4, 16, 256, 1.0),      # three chunks of the longest length
])
def test_split_twin_matches_exact_twin(dtype, b, s, h, n, chunk, dt_scale):
    """The kernel's decomposition in bf16 split products against the
    exact plain version, at the card's tolerances."""
    ins = [torch.from_numpy(t) for t in _inputs(b, s, h, n, 30, dt_scale)]
    x, dt, a, bm, cm, dy = ins
    if dtype == torch.bfloat16:
        x, bm, cm, dy = (t.to(dtype) for t in (x, bm, cm, dy))
    if dt_scale > 1.0:
        cum = np.cumsum((dt * a).numpy().reshape(b, s // chunk, chunk, h),
                        axis=2)
        assert cum.min() < -60.0
    got = ref.ssd_chunk_scan_bwd_split_ref(x, dt, a, bm, cm, dy, chunk)
    want = ref.ssd_chunk_scan_bwd_ref(x, dt, a, bm, cm, dy, chunk)
    assert [g.dtype for g in got] == [w.dtype for w in want]
    _close(got, want, _card_tol(dtype))


@pytest.mark.parametrize("s,chunk", [(128, 64), (256, 128)])
def test_split_twin_matches_jax_vjp(s, chunk):
    """Against XLA's autodiff of the reference's scan (the gradient of y
    only), on inputs whose cum stays above −60 (``ssd_chunked`` does not
    clip), float32."""
    x, dt, a, bm, cm, dy = _inputs(2, s, 3, 32, 31)
    cum = np.cumsum((dt * a).reshape(2, s // chunk, chunk, 3), axis=2)
    assert cum.min() > -60.0
    _, vjp = jax.vjp(lambda *t: jssm.ssd_chunked(*t, chunk)[0],
                     *(jnp.asarray(t) for t in (x, dt, a, bm, cm)))
    want = vjp(jnp.asarray(dy))
    got = ref.ssd_chunk_scan_bwd_split_ref(
        *(torch.from_numpy(t) for t in (x, dt, a, bm, cm, dy)), chunk)
    _close(got, want, _card_tol(torch.float32))


def test_split_twin_sums_z_over_heads():
    """dB and dC through Σ_h Z equal the per-head sums: a single head's
    inputs repeated give H times one head's Z, so dB and dC scale by H
    (to the split's precision: 3Z splits into other planes than Z)."""
    x, dt, a, bm, cm, dy = (torch.from_numpy(t) for t in
                            _inputs(1, 128, 1, 16, 32))
    one = ref.ssd_chunk_scan_bwd_split_ref(x, dt, a, bm, cm, dy, 64)
    rep = [t.repeat(1, 1, 3, *([1] * (t.dim() - 3))) for t in (x, dt)]
    three = ref.ssd_chunk_scan_bwd_split_ref(rep[0], rep[1], a.repeat(3), bm,
                                             cm, dy.repeat(1, 1, 3, 1), 64)
    for k in (3, 4):
        err = ((three[k] - 3 * one[k]).abs().max()
               / one[k].abs().max()).item()
        assert err <= 1e-4, (NAMES[k], err)

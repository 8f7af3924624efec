"""The SSD-scan backward: its plain version ``ref.ssd_chunk_scan_bwd_ref``
against autograd of ``ref.ssd_chunk_scan_ref`` and ``jax.vjp`` of the
reference's ``repro.models.ssm.ssd_chunked``, the op layer's gradient on
the CPU, and (``hopper``, on the card only) the kernel
``ssd_scan.ssd_chunk_scan_bwd`` and ``ops.SSDChunkScanFn`` against the
plain version.

Tolerances, as max |got − want| / max |want| per output: float32 1e-5
(sums in other orders), except dA 1e-3: a sum over every token of
dt·R (R the reverse cumsum of the gradient of cum), whose terms cancel:
two float32 runs of exact formulas differ by up to 1.5e-4 of it at
these inputs and by 2e-3 where dt·40 clips most decays.  So the formulas
are also held in float64 where the clip acts, at 1e-10.  On the card:
the kernel's float32 outputs and its ddt in both types 1e-4 (its
float32 sums run over 256-token chunks and the recomputed states carry
the forward's bf16 hi + lo products, ~2^-16), dA 1e-3 as above; the
bf16 outputs 2e-2 (one rounding of the output).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels import ops, ref, ssd_scan

NAMES = ("dx", "ddt", "dA", "dB", "dC")
F32_TOL = {"dx": 1e-5, "ddt": 1e-5, "dA": 1e-3, "dB": 1e-5, "dC": 1e-5}


def _inputs(b, s, h, p, n, seed, dt_scale=1.0):
    """repro's SSD test inputs (as ``test_torch_kernels._ssd_inputs``)
    and an output gradient, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)))) * dt_scale
          ).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    return x, dt, a, bm, cm, dy


def _cum_min(dt, a, chunk):
    b, s, h = dt.shape
    return float(np.cumsum((dt * a).reshape(b, s // chunk, chunk, h),
                           axis=2).min())


def _autograd(x, dt, a, bm, cm, dy, chunk):
    leaves = [t.clone().requires_grad_() for t in (x, dt, a, bm, cm)]
    y = ref.ssd_chunk_scan_ref(*leaves, chunk)
    return torch.autograd.grad(y, leaves, dy)


def _close(got, want, tol):
    for name, g, w in zip(NAMES, got, want, strict=True):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        err = np.abs(g - w).max() / np.abs(w).max()
        limit = tol[name] if isinstance(tol, dict) else tol
        assert err <= limit, (name, err)


@pytest.mark.parametrize("b,s,h,p,n,chunk,dt_scale", [
    (2, 64, 3, 16, 8, 16, 1.0),
    (2, 128, 2, 32, 16, 32, 3.0),    # cum below −60 late in a chunk
    (1, 256, 2, 16, 8, 64, 1.0),
    (1, 512, 2, 16, 8, 256, 1.0),    # cum ~ −170: the upper triangle's
                                     # exp overflows, selected away
    (2, 96, 2, 64, 24, 96, 1.0),     # one chunk: no state crosses
])
def test_twin_matches_autograd(b, s, h, p, n, chunk, dt_scale):
    """The written-out gradients equal autograd of the plain forward,
    float32."""
    x, dt, a, bm, cm, dy = (torch.from_numpy(t) for t in
                            _inputs(b, s, h, p, n, 20, dt_scale))
    got = ref.ssd_chunk_scan_bwd_ref(x, dt, a, bm, cm, dy, chunk)
    want = _autograd(x, dt, a, bm, cm, dy, chunk)
    assert got[0].dtype == torch.float32 and got[2].shape == (h,)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("chunk,dt_scale", [(32, 12.0), (16, 40.0),
                                            (64, 3.0)])
def test_twin_matches_autograd_where_clipped(monkeypatch, chunk, dt_scale):
    """Where the −60 clip takes most decays (dt scaled up), in float64
    (both plain versions compute in ``ref._F32``): a clipped entry
    passes no gradient to cum, as autograd of ``clamp(min=−60)``
    gives it."""
    x, dt, a, bm, cm, dy = _inputs(1, 128, 2, 16, 8, 21, dt_scale)
    assert _cum_min(dt, a, chunk) < -60.0
    monkeypatch.setattr(ref, "_F32", torch.float64)
    ins = [torch.from_numpy(t).double() for t in (x, dt, a, bm, cm, dy)]
    got = ref.ssd_chunk_scan_bwd_ref(*ins, chunk)
    want = _autograd(*ins, chunk)
    _close(got, want, 1e-10)


@pytest.mark.parametrize("p", [32, 64])
@pytest.mark.parametrize("s,chunk", [(64, 16), (96, 32)])
def test_twin_matches_jax_vjp_of_ssd_chunked(p, s, chunk):
    """Against XLA's autodiff of the reference's scan (the gradient of y
    only; the final state's cotangent zero), on inputs whose cum stays
    above −60, since ``ssd_chunked`` does not clip."""
    x, dt, a, bm, cm, dy = _inputs(2, s, 2, p, 16, 22)
    assert _cum_min(dt, a, chunk) > -60.0
    y, vjp = jax.vjp(lambda *t: jssm.ssd_chunked(*t, chunk)[0],
                     *(jnp.asarray(t) for t in (x, dt, a, bm, cm)))
    want = vjp(jnp.asarray(dy))
    got = ref.ssd_chunk_scan_bwd_ref(
        *(torch.from_numpy(t) for t in (x, dt, a, bm, cm, dy)), chunk)
    _close(got, want, F32_TOL)


def test_ops_ssd_is_differentiable_on_the_cpu():
    """On a CPU tensor ``ops.ssd`` is the plain version, and autograd
    through it is the twin's gradient; no kernel counts a launch."""
    x, dt, a, bm, cm, dy = (torch.from_numpy(t) for t in
                            _inputs(2, 128, 3, 64, 16, 23))
    leaves = [t.clone().requires_grad_() for t in (x, dt, a, bm, cm)]
    ops.reset_launch_counts()
    y = ops.ssd(*leaves, 64)
    y.backward(dy)
    assert not any(ops.launch_counts().values())
    _close([t.grad for t in leaves],
           ref.ssd_chunk_scan_bwd_ref(x, dt, a, bm, cm, dy, 64), F32_TOL)


def test_twin_keeps_types():
    """dx, dB and dC in their inputs' type; ddt and dA float32."""
    x, dt, a, bm, cm, dy = (torch.from_numpy(t) for t in
                            _inputs(1, 64, 2, 16, 8, 24))
    bf = torch.bfloat16
    got = ref.ssd_chunk_scan_bwd_ref(x.to(bf), dt, a, bm.to(bf), cm.to(bf),
                                     dy.to(bf), 32)
    assert [g.dtype for g in got] == [bf, torch.float32, torch.float32, bf,
                                      bf]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ref.ssd_chunk_scan_bwd_ref(x, dt, a, bm, cm, dy, 48)


def test_backward_wrapper_refuses_cpu_tensors():
    """The wrapper launches its kernel or raises: CPU tensors reach the
    plain version through the op layer only."""
    x, dt, a, bm, cm, dy = (torch.from_numpy(t) for t in
                            _inputs(1, 64, 2, 64, 16, 25))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan.ssd_chunk_scan_bwd(x, dt, a, bm, cm, dy, 64)
    with pytest.raises(ValueError, match="dy"):
        ssd_scan.ssd_chunk_scan_bwd(x, dt, a, bm, cm, dy[:, :32], 64)


# --- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs compute capability (9, 0)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(dev, dtype, b, s, h, n, dt_scale=1.0, seed=0):
    """x, B and C as column slices of one conv output (strided, as the
    mamba2 block passes them)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xbc = (torch.randn((b, s, h * 64 + 2 * n), generator=g, device=dev)
           * 0.5).to(dtype)
    x = xbc[..., :h * 64].reshape(b, s, h, 64)
    bm, cm = xbc[..., h * 64:h * 64 + n], xbc[..., h * 64 + n:]
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=g, device=dev) - 2.0) * dt_scale
    a = -torch.exp(torch.randn((h,), generator=g, device=dev) * 0.3)
    dy = torch.randn((b, s, h, 64), generator=g, device=dev).to(dtype)
    return x, dt, a, bm, cm, dy


def _card_tol(dtype):
    out = 1e-4 if dtype == torch.float32 else 2e-2
    return {"dx": out, "ddt": 1e-4, "dA": 1e-3, "dB": out, "dC": out}


_CARD_SHAPES = [
    (1, 128, 2, 16, 64, 1.0),       # the smallest chunk and state
    (2, 512, 3, 128, 256, 1.0),
    (2, 384, 3, 24, 128, 1.0),      # N padded to 128 with zeros
    (1, 1024, 2, 128, 128, 20.0),   # decays clipped at −60
    (2, 4096, 32, 128, 256, 1.0),   # one mamba2-370m layer, two lanes
]
# one mamba2-370m layer at the lm_train phase's batch of 8
_LM_TRAIN_SHAPE = (8, 4096, 32, 128, 256, 1.0)


@pytest.mark.hopper
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,n,chunk,dt_scale",
                         _CARD_SHAPES + [_LM_TRAIN_SHAPE])
def test_backward_kernel(card, dtype, b, s, h, n, chunk, dt_scale):
    """Kernel 8 against its plain version; two launches bitwise equal."""
    ins = _card_inputs(card, dtype, b, s, h, n, dt_scale)
    ops.reset_launch_counts()
    got = ssd_scan.ssd_chunk_scan_bwd(*ins, chunk)
    again = ssd_scan.ssd_chunk_scan_bwd(*ins, chunk)
    assert ops.launch_counts()["ssd_chunk_scan_bwd"] == 2
    assert all(torch.equal(u, v) for u, v in zip(got, again, strict=True))
    want = ref.ssd_chunk_scan_bwd_ref(*ins, chunk)
    assert [g.dtype for g in got] == [w.dtype for w in want]
    _close([g.float().cpu() for g in got], [w.float().cpu() for w in want],
           _card_tol(dtype))


@pytest.mark.hopper
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_function_gradients(card, dtype):
    """Autograd through ``ops.ssd`` on CUDA, x, B and C being column
    slices of one leaf as in the mamba2 block: one forward and one
    backward launch, and the leaf's gradient holds the twin's dx, dB and
    dC in its columns."""
    b, s, h, n = 2, 512, 3, 128
    x, dt, a, bm, cm, dy = _card_inputs(card, dtype, b, s, h, n)
    xbc = torch.cat([x.reshape(b, s, h * 64), bm, cm], dim=-1)
    leaves = [t.detach().clone().requires_grad_() for t in (xbc, dt, a)]
    xs, bs, cs = torch.split(leaves[0], [h * 64, n, n], dim=-1)
    ops.reset_launch_counts()
    y = ops.ssd(xs.reshape(b, s, h, 64), leaves[1], leaves[2], bs, cs, 256)
    y.backward(dy)
    counts = ops.launch_counts()
    assert counts["ssd_chunk_scan"] == counts["ssd_chunk_scan_bwd"] == 1
    gx, gb, gc = torch.split(leaves[0].grad, [h * 64, n, n], dim=-1)
    got = [gx.reshape(b, s, h, 64), leaves[1].grad, leaves[2].grad, gb, gc]
    want = ref.ssd_chunk_scan_bwd_ref(x, dt, a, bm, cm, dy, 256)
    _close([g.float().cpu() for g in got], [w.float().cpu() for w in want],
           _card_tol(dtype))

"""Port parity: the plain versions of the port's kernels against the
Pallas kernels run in interpret mode, on the CPU; and the op layer's
device dispatch.

Tolerance 1e-5 absolute for float32 (inputs of unit scale; the two
sides sum in different orders), 1e-4 where a Hermite forecast
extrapolates (it amplifies the solve's float32 round-off).  bf16
outputs are one or two roundings apart: relative 2^-7 (one bf16 step)
for a single rounding of the same float32 sum; where the plain version
rounds the forecast before adding the low band and the Pallas kernel
does not, two half steps at the largest magnitude, 2^-7 of it,
absolute.  The CUDA kernels themselves are held against these
plain versions on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frequency as jfreq
from repro.core.policies import base as jbase
from repro.kernels import dct as jdct
from repro.kernels import flash_attention as jfa
from repro.kernels import freqca_fused as jfused
from repro.kernels import ref as jref
from repro.kernels import ssd_scan as jssd
from repro.models import attention as jattn
from repro_torch.core import frequency as tfreq
from repro_torch.core.policies import base as tbase
from repro_torch.kernels import (build, dct, flash_attention, freqca_fused,
                                 ops, ref, ssd_scan)

ATOL = 1e-5


@pytest.mark.parametrize("method", ["dct", "fft", "none"])
@pytest.mark.parametrize("s,d,rho", [(64, 32, 0.0625), (128, 64, 0.125)])
def test_band_split_spectral_matches_pallas(method, s, d, rho):
    x = np.random.default_rng(1).standard_normal((2, s, d)).astype(
        np.float32)
    want_low, want_high = jdct.band_split_spectral(
        jnp.asarray(x), rho, method, block_d=32, interpret=True)
    got_low, got_high = ops.band_split_spectral(torch.from_numpy(x), rho,
                                                method)
    np.testing.assert_allclose(got_low.numpy(), np.asarray(want_low),
                               atol=ATOL)
    np.testing.assert_allclose(got_high.numpy(), np.asarray(want_high),
                               atol=ATOL)


def _rings(k, b, s, d, seed):
    """The same ring in both packages after K+1 pushes (head wrapped)."""
    rng = np.random.default_rng(seed)
    jring = jbase.ring_init(b, k, (s, d))
    tring = tbase.ring_init(b, k, (s, d))
    for t in np.linspace(1.0, 0.4, k + 1).astype(np.float32):
        v = rng.standard_normal((b, s, d)).astype(np.float32)
        jring = jbase.ring_push(jring, jnp.asarray(v), t)
        tring = tbase.ring_push(tring, torch.from_numpy(v), torch.tensor(t))
    return jring, tring


@pytest.mark.parametrize("method", ["dct", "fft"])
@pytest.mark.parametrize("k,order", [(3, 2), (4, 2)])
def test_fused_spectral_matches_pallas(method, k, order):
    s, d, rho, b = 64, 32, 0.125, 2
    jring, tring = _rings(k, b, s, d, seed=2)
    basis = jfreq.low_band_basis(s, rho, method)
    low = np.random.default_rng(3).standard_normal(
        (b, basis.shape[0], d)).astype(np.float32)
    t_q = np.float32(0.3)
    jw = jbase.ring_slot_weights(jring, t_q, order)
    want = jfused.freqca_predict_fused_spectral(
        jnp.asarray(low), basis.T, jring.vals, jw, block_s=32, block_d=32,
        interpret=True)
    tw = tbase.ring_slot_weights(tring, torch.tensor(t_q), order)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL)
    synth = torch.from_numpy(np.array(basis)).T
    got = ops.freqca_predict_spectral(torch.from_numpy(low), synth,
                                      tring.vals, tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_tf32_round_is_cvt_rna():
    """The twin's TF32 rounding: nearest on the 13 low mantissa bits,
    ties away from zero (1 + 2^-11 is a tie: up, where round-to-even
    would give 1), the 13 bits then clear, within 2^-11 relative."""
    tie = np.float32(1 + 2**-11)
    got = ref.tf32_round(torch.tensor([tie, -tie, 1 + 2**-12, 1 + 2**-10,
                                       1 + 2**-11 + 2**-20]))
    np.testing.assert_array_equal(
        got.numpy(), np.float32([1 + 2**-10, -(1 + 2**-10), 1, 1 + 2**-10,
                                 1 + 2**-10]))
    v = torch.from_numpy(np.random.default_rng(20).standard_normal(
        4096).astype(np.float32))
    r = ref.tf32_round(v)
    assert int((r.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((r - v).abs() / v.abs()).max()) <= 2**-11


@pytest.mark.parametrize("method", ["dct", "fft", "none"])
@pytest.mark.parametrize("s,d,rho,slices", [(64, 32, 0.0625, 1),
                                            (128, 64, 0.125, 2),
                                            (320, 32, 0.0625, 4)])
def test_band_split_spectral_tf32_twin_matches_pallas(method, s, d, rho,
                                                      slices):
    """The CUDA kernel's arithmetic (TF32 hi + lo products, each 32-deep
    stage summed apart, pass 1's reduction over S in slices added in
    order; 320 tokens are 10 stages, slices of 3, 3, 3 and 1) against
    the Pallas kernel in interpret mode and the plain version, float32
    within 1e-5."""
    x = np.random.default_rng(21).standard_normal((2, s, d)).astype(
        np.float32)
    want = jdct.band_split_spectral(jnp.asarray(x), rho, method, block_d=32,
                                    interpret=True)
    xt = torch.from_numpy(x)
    got = ref.band_split_spectral_tf32_ref(xt, rho, method, slices)
    plain = ref.band_split_spectral_ref(xt, rho, method)
    for g, w, p in zip(got, want, plain, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=ATOL)


@pytest.mark.parametrize("method", ["dct", "fft"])
@pytest.mark.parametrize("k,order", [(3, 2), (4, 2)])
def test_fused_spectral_tf32_twin_matches_pallas(method, k, order):
    """The cached step's CUDA arithmetic (TF32 hi + lo synthesis, the
    history added in slot order) against the Pallas kernel in interpret
    mode and the plain version, float32 within 1e-5; all three take the
    same folded weights."""
    s, d, rho, b = 64, 32, 0.125, 2
    jring, tring = _rings(k, b, s, d, seed=22)
    basis = jfreq.low_band_basis(s, rho, method)
    low = np.random.default_rng(23).standard_normal(
        (b, basis.shape[0], d)).astype(np.float32)
    jw = jbase.ring_slot_weights(jring, np.float32(0.3), order)
    want = jfused.freqca_predict_fused_spectral(
        jnp.asarray(low), basis.T, jring.vals, jw, block_s=32, block_d=32,
        interpret=True)
    args = (torch.from_numpy(low), torch.from_numpy(np.array(basis)).T,
            tring.vals, torch.from_numpy(np.array(jw)))
    got = ref.freqca_predict_spectral_tf32_ref(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(
        got.numpy(), ref.freqca_predict_spectral_ref(*args).numpy(),
        atol=ATOL)


def test_single_tf32_product_misses_float32_tolerance():
    """Control of the twins: at S 512 one emulated TF32 product (both
    operands rounded once, as a TF32 matmul runs) misses 1e-5 against
    the float64 product, where the split product passes it."""
    rng = np.random.default_rng(24)
    x = rng.standard_normal((2, 512, 64)).astype(np.float32)
    basis = tfreq.low_band_basis(512, 0.0625, "dct")
    want = np.einsum("ms,bsd->bmd", basis.double().numpy(),
                     x.astype(np.float64))
    xt = torch.from_numpy(x)
    single = ref.tf32_round(basis) @ ref.tf32_round(xt)
    split = ref.tf32_split_matmul(basis, xt)
    assert np.abs(single.numpy() - want).max() > ATOL
    np.testing.assert_allclose(split.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("s,h,hd", [(64, 2, 16), (96, 3, 64)])
def test_flash_attention_matches_pallas(s, h, hd):
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, s, h, hd)).astype(np.float32)
               for _ in range(3))
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), 1, causal=False,
                               q_block=32, kv_block=32, interpret=True)
    got = ops.flash(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _rel_close(got, want, rtol=ATOL):
    """max |got − want| <= rtol · max |want| (float32, unit-scale)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("s,hq,hkv", [(64, 4, 2), (128, 8, 8), (64, 6, 2)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_flash_forms_match_pallas(s, hq, hkv, causal, window):
    """Every (causal, window, q_per_kv) case of repro's own flash test:
    the port's plain attention (the op layer's CPU route) against the
    Pallas kernel in interpret mode and the reference's ``_sdpa``.
    Tolerance 1e-5 relative to the largest output (float32)."""
    rng = np.random.default_rng(14)
    q = rng.standard_normal((2, s, hq, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, s, hkv, 16)).astype(np.float32)
            for _ in "kv")
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), hq // hkv, causal=causal,
                               window=window, q_block=32, kv_block=32,
                               interpret=True)
    got = ops.flash(*(torch.from_numpy(a) for a in (q, k, v)), hq // hkv,
                    causal=causal, window=window)
    _rel_close(got.numpy(), want)
    mask = (jattn.causal_mask(s, window=window) if causal
            else jnp.ones((1, s, s), bool))
    _rel_close(got.numpy(), jattn._sdpa(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), mask, hq // hkv))


def _ssd_inputs(b, s, h, p, n, seed):
    """repro's own SSD test inputs, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("s,chunk", [(32, 8), (64, 16), (128, 32),
                                     (64, 64)])
def test_ssd_chunk_scan_ref_matches_pallas_and_naive(s, chunk):
    """The port's plain SSD scan (the op layer's CPU route) against the
    Pallas kernel in interpret mode, and both naive recurrences.
    Tolerance 1e-5 relative to the largest output (float32)."""
    ins = _ssd_inputs(2, s, 2, 16, 8, seed=15)
    want = jssd.ssd_chunk_scan(*(jnp.asarray(a) for a in ins), chunk,
                               interpret=True)
    got = ops.ssd(*(torch.from_numpy(a) for a in ins), chunk)
    assert got.shape == (2, s, 2, 16) and got.dtype == torch.float32
    _rel_close(got.numpy(), want)
    naive, state = ref.ssd_naive_ref(*(torch.from_numpy(a) for a in ins))
    jnaive, jstate = jref.ssd_naive_ref(*(jnp.asarray(a) for a in ins))
    _rel_close(naive.numpy(), jnaive)
    _rel_close(state.numpy(), jstate)
    _rel_close(got.numpy(), naive.numpy())


def test_ssd_chunk_scan_ref_keeps_bf16_and_clips():
    """Output in x's type; a decay past the −60 clip stays finite (the
    upper triangle's overflowing exp is selected away, not multiplied)."""
    x, dt, a, bm, cm = (torch.from_numpy(t) for t in
                        _ssd_inputs(1, 32, 2, 16, 8, seed=16))
    y = ref.ssd_chunk_scan_ref(x.to(torch.bfloat16), dt * 40.0, a,
                               bm.to(torch.bfloat16), cm.to(torch.bfloat16),
                               32)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y).all()
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ref.ssd_chunk_scan_ref(x[:, :24], dt[:, :24], a, bm[:, :24],
                               cm[:, :24], 16)


@pytest.mark.parametrize("s,chunk,dt_scale", [(64, 16, 1.0), (128, 32, 1.0),
                                              (64, 64, 1.0), (128, 32, 3.0),
                                              (96, 32, 12.0),
                                              (128, 16, 40.0)])
def test_ssd_chunk_parallel_decomposition_matches_pallas(s, chunk, dt_scale):
    """The CUDA kernel's chunk-parallel algorithm (C Bᵀ once per lane and
    chunk, per-chunk contributions, states passed over the chunks, then
    each chunk's output) against the sequential plain scan and the
    Pallas kernel in interpret mode.  dt_scale 3 takes cum below −60
    late in a chunk, 12 and 40 early in every chunk (so does a chunk of
    64 at dt_scale 1 for one head), so decays are
    clipped inside chunks and the state crosses chunks through clipped
    decays; the clip applies per chunk in all three.  Tolerance 1e-5
    relative to the largest output (float32)."""
    x, dt, a, bm, cm = _ssd_inputs(2, s, 3, 16, 8, seed=18)
    dt = (dt * dt_scale).astype(np.float32)
    cum = np.cumsum((dt * a).reshape(2, s // chunk, chunk, 3), axis=2)
    assert cum.min() < -60.0 or dt_scale == 1.0
    ins = (x, dt, a, bm, cm)
    want = jssd.ssd_chunk_scan(*(jnp.asarray(t) for t in ins), chunk,
                               interpret=True)
    tins = [torch.from_numpy(t) for t in ins]
    got = ref.ssd_chunk_scan_parallel_ref(*tins, chunk)
    assert got.shape == (2, s, 3, 16) and torch.isfinite(got).all()
    _rel_close(got.numpy(), want)
    _rel_close(got.numpy(), ref.ssd_chunk_scan_ref(*tins, chunk).numpy())


def test_attention_ref_is_the_full_logits_branch():
    """bf16 rounds the probabilities before PV, as dit.py:131 does."""
    from repro.models import dit as jdit
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, 24, 2, 16)).astype(np.float32)
               for _ in range(3))
    p_out = np.eye(32, dtype=np.float32).reshape(2, 16, 32)
    want = jdit._joint_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(p_out),
                                 jnp.float32)
    got = ref.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.reshape(1, 24, 32).numpy(),
                               np.asarray(want), atol=ATOL)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    assert ref.attention_ref(qb, kb, vb).dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,d", [(64, 32), (128, 128), (256, 64)])
def test_token_basis_matmul_matches_pallas(s, d, dtype):
    x = np.random.default_rng(11).standard_normal((2, s, d)).astype(
        np.float32)
    basis = jfreq.dct_basis(s)
    want = jdct.token_basis_matmul(basis, jnp.asarray(x).astype(dtype),
                                   block_s=64, block_d=32, block_k=64,
                                   interpret=True)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ops.dct_tokens(xt)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_array_equal(tfreq.dct_basis(s).numpy(),
                                  np.asarray(basis))
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7,
                                   atol=1e-6)


@pytest.mark.parametrize("method", ["dct", "fft"])
@pytest.mark.parametrize("s,d,rho", [(64, 32, 0.0625), (128, 64, 0.125),
                                     (256, 48, 0.25)])
def test_band_split_matches_pallas(method, s, d, rho):
    x = np.random.default_rng(12).standard_normal((2, s, d)).astype(
        np.float32)
    want_low, want_high = jdct.band_split(jnp.asarray(x), rho, method,
                                          interpret=True)
    got_low, got_high = ops.band_split(torch.from_numpy(x), rho, method)
    np.testing.assert_allclose(got_low.numpy(), np.asarray(want_low),
                               atol=ATOL)
    np.testing.assert_allclose(got_high.numpy(), np.asarray(want_high),
                               atol=ATOL)
    np.testing.assert_allclose((got_low + got_high).numpy(), x, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,order", [(2, 1), (3, 1), (3, 2)])
def test_freqca_predict_fused_matches_pallas(k, order, dtype):
    """The legacy cached step over a K-major history.  (K = 2 at order
    2 fits three coefficients to two points: its weights exist only
    through the 1e-6 jitter and are float32 noise, so it is left out.)"""
    rng = np.random.default_rng(13)
    b, s, d = 2, 64, 32
    low = rng.standard_normal((b, s, d)).astype(np.float32)
    hist = rng.standard_normal((k, b, s, d)).astype(np.float32)
    ts = _GRID[[2, 5, 10][-k:]]
    t_q = _GRID[12]
    jd = getattr(jnp, dtype)
    want = jfused.freqca_predict_fused(
        jnp.asarray(low).astype(jd), jnp.asarray(hist).astype(jd),
        jnp.asarray(ts), t_q, order, block_s=32, block_d=32, interpret=True)
    td = getattr(torch, dtype)
    got = ops.freqca_predict(torch.from_numpy(low).to(td),
                             torch.from_numpy(hist).to(td),
                             torch.from_numpy(ts), torch.tensor(t_q), order)
    assert got.dtype == td and got.shape == (b, s, d)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    else:
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=2**-7 * np.abs(want).max())
    tw = freqca_fused.hermite_eval_weights(torch.from_numpy(ts),
                                           torch.tensor(t_q), order)
    jw = jfused.hermite_eval_weights(jnp.asarray(ts), t_q, order)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL)


# times of a 20-step grid, as the samplers step through them
_GRID = (1.0 - np.arange(21) / 20).astype(np.float32)


@pytest.mark.parametrize("call", ["band_split", "fused", "flash",
                                  "token_basis_matmul", "band_split_full",
                                  "freqca_predict_fused", "flash_causal_gqa",
                                  "ssd"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """A wrapper launches its kernel or raises: it never computes the
    plain version itself (the op layer alone routes CPU tensors)."""
    x = torch.zeros((1, 64, 64, 64))
    with pytest.raises(ValueError, match="CUDA"):
        if call == "band_split":
            dct.band_split_spectral(x[0], 0.0625, "dct")
        elif call == "fused":
            freqca_fused.freqca_predict_fused_spectral(
                torch.zeros((1, 4, 64)), torch.zeros((64, 4)),
                torch.zeros((1, 3, 64, 64)), torch.zeros((1, 3)))
        elif call == "flash":
            flash_attention.flash_attention(x, x, x)
        elif call == "token_basis_matmul":
            dct.token_basis_matmul(torch.eye(64), x[0])
        elif call == "band_split_full":
            dct.band_split(x[0], 0.0625, "dct")
        elif call == "flash_causal_gqa":
            flash_attention.flash_attention(x, x[:, :, :16], x[:, :, :16], 4,
                                            causal=True, window=16)
        elif call == "ssd":
            ssd_scan.ssd_chunk_scan(x, x[..., 0], torch.zeros(64),
                                    x[:, :, 0], x[:, :, 0], 64)
        else:
            freqca_fused.freqca_predict_fused(
                x[0], torch.zeros((3, 64, 64, 64)), torch.ones(3),
                torch.tensor(0.5), 2)


def test_cpu_dispatch_leaves_launch_counts_untouched():
    ops.reset_launch_counts()
    x = torch.randn(1, 64, 32)
    ops.band_split_spectral(x)
    ops.flash(*(torch.randn(1, 64, 2, 64) for _ in range(3)))
    ops.dct_tokens(x)
    ops.band_split(x)
    ops.freqca_predict(x, torch.randn(3, 1, 64, 32),
                       torch.tensor([0.9, 0.8, 0.7]), torch.tensor(0.6))
    ops.flash(torch.randn(1, 64, 4, 64), *(torch.randn(1, 64, 1, 64)
                                           for _ in "kv"), 4, causal=True)
    ops.ssd(*(torch.from_numpy(t) for t in _ssd_inputs(1, 64, 2, 64, 16, 0)),
            64)
    assert ops.launch_counts() == {"band_split_spectral": 0,
                                   "freqca_predict_fused_spectral": 0,
                                   "flash_attention": 0,
                                   "flash_attention_bwd": 0,
                                   "token_basis_matmul": 0,
                                   "freqca_predict_fused": 0,
                                   "ssd_chunk_scan": 0,
                                   "ssd_chunk_scan_bwd": 0,
                                   "flash_attention_f32": 0,
                                   "flash_attention_f32_bwd": 0}


@pytest.mark.parametrize("bad", ["head_dim", "state", "chunk", "types"])
def test_ssd_wrapper_rejects_shapes_the_kernel_lacks(bad):
    """Checked before the device: the kernel takes head_dim 64, d_state a
    multiple of 8 up to 128, a chunk a multiple of 64 up to 256."""
    b, s, h, p, n, chunk = 1, 128, 2, 64, 16, 64
    if bad == "head_dim":
        p = 32
    elif bad == "state":
        n = 12
    elif bad == "chunk":
        chunk = 32
    x, dt, a, bm, cm = (torch.from_numpy(t) for t in
                        _ssd_inputs(b, s, h, p, n, seed=17))
    if bad == "types":
        dt = dt.to(torch.bfloat16)
    with pytest.raises(TypeError if bad == "types" else ValueError,
                       match="ssd_chunk_scan"):
        ssd_scan.ssd_chunk_scan(x, dt, a, bm, cm, chunk)


def test_build_targets_sm90a_and_hashes_sources():
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    paths = {build.lib_path(n) for n in build.KERNELS}
    assert len(paths) == len(build.KERNELS)
    assert all(p.parent == build.BUILD_DIR for p in paths)
    for name in build.KERNELS:
        assert (build.CSRC / f"{name}.cu").exists()


def test_dtype_code_rejects_other_types():
    assert build.dtype_code(torch.zeros(1)) == 0
    assert build.dtype_code(torch.zeros(1, dtype=torch.bfloat16)) == 1
    with pytest.raises(TypeError):
        build.dtype_code(torch.zeros(1, dtype=torch.float16))


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"

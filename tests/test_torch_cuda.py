"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an sm_90 device and carries the ``hopper`` marker;
without one it skips (the CUDA kernels have no interpret mode).  On the
card:  ``PYTHONPATH=src python -m pytest -q -m hopper tests/``.

Tolerances, as max |kernel − plain| / max |plain|: float32 1e-5 (the
two sum in different orders; 1e-4 for the SSD scan, whose chunk sums
run over 256 tokens and whose decays multiply), bf16 2e-2 (one rounding
of the output; for attention, kernel and plain version both round the
probabilities to bf16 before P·V, so they differ by the order of the
sums, the kernel's rounding of unnormalised probabilities and the
output's rounding).
"""
import pytest
import torch

from repro_torch.core import frequency
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.hopper
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs compute capability (9, 0)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs().max() / w.float().abs().max()
        assert float(err) <= TOL[dtype], float(err)


# (S, D) at the edges of the two TF32 kernels' tiles: pass 1 and its
# 128 x 128 tiles split the reduction over S in slices, pass 2 and the
# cached step take 128 x 64 tiles.  S 320 and D 200 are off every tile
# edge; (77, 9) has rows that are not 16-byte aligned (plain loads, the
# history read from global memory); S 4000 is 125 stages, so pass 1's
# last slice is short; (4096, 256) is deep (fft: m = 257, a masked K
# tail and a 1-row third tile of spectral rows).
_SPECTRAL_SHAPES = [(320, 200), (77, 9), (4000, 136), (4096, 256)]


# batch 1 is how a MixedBank lane launches both kernels; 3 is odd
_BATCHES = [1, 2, 3]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("method", ["dct", "fft"])
@pytest.mark.parametrize("s,d", _SPECTRAL_SHAPES)
@pytest.mark.parametrize("b", _BATCHES)
def test_band_split_kernel(card, dtype, method, s, d, b):
    x = torch.randn(b, s, d, device=card).to(dtype)
    ops.reset_launch_counts()
    got = ops.band_split_spectral(x, 0.0625, method)
    assert ops.launch_counts()["band_split_spectral"] == 1
    _close(got, ref.band_split_spectral_ref(x, 0.0625, method), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("method", ["dct", "fft"])
@pytest.mark.parametrize("s,d", _SPECTRAL_SHAPES)
@pytest.mark.parametrize("k", [3, 6])
@pytest.mark.parametrize("b", _BATCHES)
def test_fused_spectral_kernel(card, dtype, method, s, d, k, b):
    """K 6 float32 entries are more than shared memory holds beside the
    operand ring (4), so the last two are read from global memory."""
    basis = frequency.low_band_basis(s, 0.0625, method, device=card)
    low = torch.randn(b, basis.shape[0], d, device=card).to(dtype)
    hist = torch.randn(b, k, s, d, device=card).to(dtype)
    w = torch.randn(b, k, device=card)
    ops.reset_launch_counts()
    got = ops.freqca_predict_spectral(low, basis.T, hist, w)
    assert ops.launch_counts()["freqca_predict_fused_spectral"] == 1
    _close((got,), (ref.freqca_predict_spectral_ref(low, basis.T, hist, w),),
           dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_spectral_kernel_reads_synth_strided(card, dtype):
    """The policy's synth is the view basis.T; a contiguous copy of it
    gives bitwise the same output."""
    basis = frequency.low_band_basis(4096, 0.0625, "fft", device=card)
    low = torch.randn(2, basis.shape[0], 256, device=card).to(dtype)
    hist = torch.randn(2, 3, 4096, 256, device=card).to(dtype)
    w = torch.randn(2, 3, device=card)
    assert not basis.T.is_contiguous()
    got = ops.freqca_predict_spectral(low, basis.T, hist, w)
    assert torch.equal(got, ops.freqca_predict_spectral(
        low, basis.T.contiguous(), hist, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["band_split", "fused"])
def test_spectral_kernels_are_deterministic(card, dtype, kernel):
    """No float atomics: pass 1's slices are added in a fixed order, so
    two launches give bitwise-equal outputs."""
    x = torch.randn(2, 4096, 1024, device=card).to(dtype)
    if kernel == "band_split":
        def run():
            return ops.band_split_spectral(x, 0.0625, "dct")
    else:
        basis = frequency.low_band_basis(4096, 0.0625, "dct", device=card)
        low = torch.randn(2, basis.shape[0], 1024, device=card).to(dtype)
        hist = torch.stack([x, 0.5 * x, -x], dim=1)
        w = torch.randn(2, 3, device=card)

        def run():
            return (ops.freqca_predict_spectral(low, basis.T, hist, w),)
    for a, b in zip(run(), run(), strict=True):
        assert torch.equal(a, b)


def _tf32_matmul(a, b):
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def test_band_split_spectral_split_is_live(card):
    """float32 at S 4096: the kernel (TF32 hi + lo splits) passes 1e-5;
    the control, the same two products by torch.matmul with TF32
    allowed, fails the same check, so the split is what passes."""
    x = torch.randn(2, 4096, 256, device=card)
    want = ref.band_split_spectral_ref(x, 0.0625, "dct")
    ops.reset_launch_counts()
    got = ops.band_split_spectral(x, 0.0625, "dct")
    assert ops.launch_counts()["band_split_spectral"] == 1
    _close(got, want, torch.float32)
    basis = frequency.low_band_basis(4096, 0.0625, "dct", device=card)
    low = _tf32_matmul(basis, x)
    high = x - _tf32_matmul(basis.T, low)
    err = max(_rel_err(low, want[0]), _rel_err(high, want[1]))
    assert err > TOL[torch.float32], err


def test_fused_spectral_split_is_live(card):
    """float32 at S 4096, as above: the cached step's kernel passes
    1e-5, the synthesis by torch.matmul with TF32 allowed fails it.
    Weights of scale 0.1 keep the output the synthesis's, so that its
    error is what the check sees."""
    basis = frequency.low_band_basis(4096, 0.0625, "dct", device=card)
    low = torch.randn(2, basis.shape[0], 256, device=card)
    hist = torch.randn(2, 3, 4096, 256, device=card)
    w = 0.1 * torch.randn(2, 3, device=card)
    want = ref.freqca_predict_spectral_ref(low, basis.T, hist, w)
    ops.reset_launch_counts()
    got = ops.freqca_predict_spectral(low, basis.T, hist, w)
    assert ops.launch_counts()["freqca_predict_fused_spectral"] == 1
    _close((got,), (want,), torch.float32)
    tf32 = _tf32_matmul(basis.T, low) + torch.einsum("bk,bksd->bsd", w, hist)
    assert _rel_err(tf32, want) > TOL[torch.float32], _rel_err(tf32, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,t,hd", [(200, 200, 64), (64, 130, 128),
                                    (200, 200, 128), (64, 130, 64),
                                    (300, 77, 128), (300, 77, 64)])
def test_flash_kernel(card, dtype, s, t, hd):
    """S and T off the tile edges (the bf16 kernel's tiles are 128
    queries by 96 keys at hd 128, 128 by 128 at hd 64); T = 77 is
    shorter than one key tile."""
    q = torch.randn(2, s, 3, hd, device=card).to(dtype)
    k, v = (torch.randn(2, t, 3, hd, device=card).to(dtype) for _ in "kv")
    ops.reset_launch_counts()
    got = ops.flash(q, k, v)
    assert ops.launch_counts()["flash_attention"] == 1
    _close((got,), (ref.attention_ref(q, k, v),), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("call", ["dct_tokens", "dct", "fft", "decompose"])
@pytest.mark.parametrize("shape", [(2, 200, 136), (1, 77, 9),
                                   (2, 4096, 3072)])
def test_token_basis_matmul_kernel(card, dtype, call, shape):
    """Ragged S and D (neither a multiple of the 128-wide tiles);
    (1, 77, 9) has rows that are not 16-byte aligned, so the stages are
    filled by plain loads; (2, 4096, 3072) is the analysis path's shape,
    128 stages of the cp.async ring per block, so its steady state runs.
    ``decompose`` on a CUDA ``[B, S, D]`` tensor reaches the kernel."""
    x = torch.randn(*shape, device=card).to(dtype)
    ops.reset_launch_counts()
    if call == "dct_tokens":
        got = (ops.dct_tokens(x),)
        want = (ref.token_basis_matmul_ref(
            frequency.dct_basis(shape[1], device=card), x),)
    elif call == "decompose":
        got = tuple(frequency.decompose(x, 0.0625, "fft"))
        want = ref.band_split_ref(x, 0.0625, "fft")
    else:
        got = ops.band_split(x, 0.0625, call)
        want = ref.band_split_ref(x, 0.0625, call)
    assert ops.launch_counts()["token_basis_matmul"] == 1
    _close(got, want, dtype)


def test_token_basis_matmul_split_is_live(card):
    """float32: random unit-scale x under the DCT basis, where a single
    TF32 product keeps ~11 bits and misses 1e-5.  The kernel (TF32 hi + lo
    splits, three products) passes 1e-5; the control, torch.matmul with
    TF32 allowed, must fail the same check, so the split is what passes."""
    x = torch.randn(2, 512, 256, device=card)
    basis = frequency.dct_basis(512, device=card)
    want = ref.token_basis_matmul_ref(basis, x)
    ops.reset_launch_counts()
    got = ops.dct_tokens(x)
    assert ops.launch_counts()["token_basis_matmul"] == 1
    _close((got,), (want,), torch.float32)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = torch.matmul(basis, x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    err = (tf32 - want).abs().max() / want.abs().max()
    assert float(err) > TOL[torch.float32], float(err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 48), (2, 33, 7)])
def test_freqca_predict_fused_kernel(card, dtype, shape):
    """(2, 33, 7) has 462 elements: not a multiple of the 16-byte
    vector, so every element takes the scalar tail."""
    low = torch.randn(shape, device=card).to(dtype)
    hist = torch.randn((3,) + shape, device=card).to(dtype)
    ts = torch.tensor([0.75, 0.5, 0.25], device=card)
    t_q = torch.tensor(0.2, device=card)
    ops.reset_launch_counts()
    got = ops.freqca_predict(low, hist, ts, t_q, 2)
    assert ops.launch_counts()["freqca_predict_fused"] == 1
    _close((got,), (ref.freqca_predict_ref(low, hist, ts, t_q, 2),), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,hq,hkv,hd,causal,window", [
    (200, 4, 1, 128, True, 0),      # causal GQA, ragged S
    (256, 8, 2, 64, True, 48),      # causal, window inside a tile
    (192, 4, 2, 128, False, 0),     # non-causal GQA
    (130, 2, 2, 64, False, 70),     # non-causal window, ragged
    (300, 16, 2, 128, True, 0),     # q_per_kv 8 (yi-9b), ragged
    (520, 16, 2, 64, False, 0),     # non-causal, q_per_kv 8, hd 64
    (1000, 8, 1, 128, True, 50),    # window narrower than a key tile
    (1000, 8, 8, 64, True, 300),    # window wider than a key tile
    (700, 8, 1, 128, False, 300),   # non-causal window wider than a tile
])
def test_flash_kernel_masked_and_gqa_forms(card, dtype, s, hq, hkv, hd,
                                           causal, window):
    """Each new form against the plain masked GQA attention; tiles
    wholly above the diagonal or before the window are skipped."""
    q = torch.randn(2, s, hq, hd, device=card).to(dtype)
    k, v = (torch.randn(2, s, hkv, hd, device=card).to(dtype) for _ in "kv")
    ops.reset_launch_counts()
    got = ops.flash(q, k, v, hq // hkv, causal=causal, window=window)
    assert ops.launch_counts()["flash_attention"] == 1
    _close((got,), (ref.attention_ref(q, k, v, hq // hkv, causal, window),),
           dtype)


@pytest.mark.parametrize("s,hq,hkv,hd,causal", [
    (333, 32, 4, 128, True),        # yi-9b's heads, causal GQA
    (333, 2, 2, 64, False),
])
def test_flash_kernel_sharp_softmax(card, s, hq, hkv, hd, causal):
    """bf16 with q scaled so that the logits' std is ~80: the sharp
    softmax of the random yi-9b weights (the reference's init gives the
    stacked attention projections std 1/sqrt(n_layers))."""
    q = (torch.randn(2, s, hq, hd, device=card) * 80.0).to(torch.bfloat16)
    k, v = (torch.randn(2, s, hkv, hd, device=card).to(torch.bfloat16)
            for _ in "kv")
    ops.reset_launch_counts()
    got = ops.flash(q, k, v, hq // hkv, causal=causal)
    assert ops.launch_counts()["flash_attention"] == 1
    _close((got,), (ref.attention_ref(q, k, v, hq // hkv, causal),),
           torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,chunk,n,dt_scale", [
    (512, 256, 128, 1.0), (384, 128, 64, 1.0), (256, 64, 16, 1.0),
    (192, 64, 24, 1.0),             # N padded to 32 in the kernel
    (4096, 256, 128, 1.0),          # mamba2-370m's 16 chunks of 256
    (1024, 128, 128, 20.0),         # decays clipped at −60
])
def test_ssd_chunk_scan_kernel(card, dtype, s, chunk, n, dt_scale):
    """x, B and C as column slices of one conv output (strided, as the
    mamba2 block passes them); float32 dt, scaled by dt_scale.  N 24 is
    not a multiple of the kernel's 16-wide steps, so the state is padded
    with zeros; 16 chunks pass the states over many chunks; at dt_scale
    20 cum falls below −60 inside every chunk, so decays are clipped
    inside chunks and the state crosses chunks through the clipped
    exp(cum_Q)."""
    b, h, p = 2, 3, 64
    xbc = torch.randn(b, s, h * p + 2 * n, device=card) * 0.5
    xbc = xbc.to(dtype)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, device=card))
    dt = dt * dt_scale
    a = -torch.exp(torch.randn(h, device=card) * 0.3)
    if dt_scale > 1:
        cum = (dt * a).reshape(b, s // chunk, chunk, h).cumsum(dim=2)
        assert float(cum[:, :, -1].max()) < -60.0
    ops.reset_launch_counts()
    got = ops.ssd(x, dt, a, bm, cm, chunk)
    assert ops.launch_counts()["ssd_chunk_scan"] == 1
    want = ref.ssd_chunk_scan_ref(x, dt, a, bm, cm, chunk)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}[dtype]
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert got.dtype == dtype and float(err) <= tol, float(err)


# the flash backward: (S, Hq, Hkv, hd, causal, window) in the four forms,
# S off the tiles (128 keys / queries a block, two warpgroups of 64;
# streamed tiles of 64 queries, and of 128 keys at hd 128, 64 at hd 64)
_BWD_FORMS = [
    (200, 3, 3, 64, False, 0),      # non-causal MHA, ragged
    (300, 4, 4, 128, False, 0),
    (333, 4, 4, 128, True, 0),      # causal
    (256, 8, 2, 64, True, 48),      # causal window inside a tile
    (1000, 8, 8, 128, True, 300),   # window wider than a tile
    (300, 16, 2, 128, True, 0),     # causal GQA, q_per_kv 8 (yi-9b)
    (520, 8, 2, 64, False, 0),      # non-causal GQA
    (130, 4, 1, 128, False, 70),    # non-causal window, GQA
    (777, 4, 4, 64, False, 0),      # 7 key tiles, 13 streamed, S ragged
    (512, 4, 4, 128, False, 0),     # whole tiles only (no ragged edge)
    (700, 16, 2, 128, True, 0),     # causal GQA q_per_kv 8, 6 key tiles
    (450, 8, 1, 64, True, 0),       # causal GQA q_per_kv 8 at hd 64
    (50, 2, 2, 128, True, 0),       # one tile, the second warpgroup idle
    (1152, 32, 4, 64, True, 0),     # 72 kv blocks: on 132 SMs the group's
                                    # 8 heads split over 4 blocks of 2
]
# (S, T, Hq, Hkv, hd, causal, window) with T != S: every query sees a
# key (no window past T)
_BWD_CROSS = [
    (200, 328, 4, 4, 128, False, 0),
    (333, 190, 4, 2, 64, False, 0),
    (300, 420, 8, 2, 128, True, 0),
    (260, 390, 4, 4, 64, True, 100),
]


def _bwd_inputs(card, s, hq, hkv, hd, dtype=torch.bfloat16, b=2, t=None):
    q = torch.randn(b, s, hq, hd, device=card).to(dtype)
    k, v = (torch.randn(b, t or s, hkv, hd, device=card).to(dtype)
            for _ in "kv")
    do = torch.randn(b, s, hq, hd, device=card).to(dtype)
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,hq,hkv,hd,causal,window", _BWD_FORMS)
def test_flash_kernel_lse(card, dtype, s, hq, hkv, hd, causal, window):
    """The forward with the log-sum-exp written: the output equals the
    one without it, bit for bit, and lse the twin's to 1e-5 absolute
    (values ~log T, float32)."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, _ = _bwd_inputs(card, s, hq, hkv, hd, dtype)
    g = hq // hkv
    out, lse = fa.flash_attention(q, k, v, g, causal, window,
                                  return_lse=True)
    assert torch.equal(out, fa.flash_attention(q, k, v, g, causal, window))
    want_out, want_lse = ref.attention_lse_ref(q, k, v, g, causal, window)
    _close((out,), (want_out,), dtype)
    assert lse.shape == (2, hq, s) and lse.dtype == torch.float32
    assert float((lse - want_lse).abs().max()) <= 1e-5 * float(
        want_lse.abs().max())


@pytest.mark.parametrize("s,hq,hkv,hd,causal,window", _BWD_FORMS)
def test_flash_bwd_kernel(card, s, hq, hkv, hd, causal, window):
    """dQ, dK, dV against the recompute twin on the same o and lse (bf16
    2e-2, as the forward: both round P and dS to bf16 as operands), and
    two launches bitwise equal (no atomics)."""
    _check_flash_bwd(_bwd_inputs(card, s, hq, hkv, hd), hq // hkv, causal,
                     window)


@pytest.mark.parametrize("s,t,hq,hkv,hd,causal,window", _BWD_CROSS)
def test_flash_bwd_kernel_cross_lengths(card, s, t, hq, hkv, hd, causal,
                                        window):
    """The same with T keys for S queries, T != S."""
    _check_flash_bwd(_bwd_inputs(card, s, hq, hkv, hd, t=t), hq // hkv,
                     causal, window)


def _check_flash_bwd(inputs, g, causal, window):
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = inputs
    o, lse = fa.flash_attention(q, k, v, g, causal, window, return_lse=True)
    ops.reset_launch_counts()
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, g, causal, window)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, g, causal, window)
    assert ops.launch_counts()["flash_attention_bwd"] == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again, strict=True))
    _close(got, ref.attention_bwd_ref(q, k, v, o, lse, do, g, causal,
                                      window), torch.bfloat16)


@pytest.mark.parametrize("causal,hkv", [(False, 4), (True, 2)])
def test_flash_autograd_function(card, causal, hkv):
    """``ops.flash`` under autograd: the forward kernel saves o and lse,
    the backward kernel gives the gradients of a loss through it, equal
    to autograd through the plain version within bf16 2e-2."""
    q, k, v, do = _bwd_inputs(card, 160, 4, hkv, 64)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ops.reset_launch_counts()
    out = ops.flash(*leaves, 4 // hkv, causal=causal)
    (out.float() * do.float()).sum().backward()
    assert ops.launch_counts()["flash_attention"] == 1
    assert ops.launch_counts()["flash_attention_bwd"] == 1
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ref.attention_ref(*plain, 4 // hkv, causal),
                               plain, do)
    _close(tuple(x.grad for x in leaves), want, torch.bfloat16)
    with torch.no_grad():
        ops.reset_launch_counts()
        ops.flash(q, k, v, 4 // hkv, causal=causal)
    assert ops.launch_counts()["flash_attention_bwd"] == 0


# float32 at head widths 33 to 128 (``flash_bwd_tf32.cuh``, instances 64
# and 128): (B, S, T, Hq, Hkv, hd, causal, window) in every form at hd
# 64, 72 (DiT-XL's), 96 (Phi-3's) and 128: non-causal MHA and GQA, causal
# GQA, causal and non-causal windows, T != S both ways, T shorter than a
# tile; S and T off the 128-row blocks and the 32- and 64-row tiles
_F32_WIDE_FORMS = [
    (2, 333, 333, 4, 4, 64, False, 0),
    (2, 300, 300, 8, 2, 64, True, 0),
    (1, 400, 400, 4, 4, 64, False, 90),
    (2, 1024, 1024, 8, 8, 72, False, 0),
    (1, 333, 333, 6, 2, 72, True, 24),
    (1, 1000, 1000, 8, 8, 96, True, 0),
    (1, 200, 700, 4, 1, 96, False, 0),
    (1, 520, 520, 8, 2, 128, True, 100),
    (2, 260, 390, 4, 2, 128, False, 0),
    (1, 300, 20, 4, 4, 128, False, 0),
    (2, 300, 300, 4, 1, 128, True, 0),
]


@pytest.mark.parametrize("b,s,t,hq,hkv,hd,causal,window", _F32_WIDE_FORMS)
def test_flash_f32_wide_backward_forms(card, b, s, t, hq, hkv, hd, causal,
                                       window):
    """Kernel 7 in float32 at head widths 33 to 128 in every form: dQ,
    dK, dV against the float64 oracle (the recompute twin on float64
    inputs, from the kernel's own o and lse) within twice the float32
    twin's own error (at least 1e-5), and against the twin itself at
    1e-5; two launches bitwise equal, one launch a call on
    ``flash_attention_bwd``; ``ops.flash`` under autograd reaching the
    forward and this backward, its gradients those of the direct call."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = _bwd_inputs(card, s, hq, hkv, hd, torch.float32, b=b,
                              t=t)
    g = hq // hkv
    o, lse = fa.flash_attention(q, k, v, g, causal, window, return_lse=True)
    ops.reset_launch_counts()
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, g, causal, window)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, g, causal, window)
    counts = ops.launch_counts()
    assert counts["flash_attention_bwd"] == 2 and sum(counts.values()) == 2
    assert all(torch.equal(a, c) for a, c in zip(got, again, strict=True))
    assert all(a.dtype == torch.float32 for a in got)
    plain = ref.attention_bwd_ref(q, k, v, o, lse, do, g, causal, window)
    _close(got, plain, torch.float32)
    oracle = ref.attention_bwd_ref(*(x.double() for x in (q, k, v, o, lse,
                                                          do)), g, causal,
                                   window)
    for a, p, w in zip(got, plain, oracle, strict=True):
        lim = max(TOL[torch.float32], 2 * _rel64(p, w))
        assert _rel64(a, w) <= lim, (_rel64(a, w), lim)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ops.reset_launch_counts()
    (ops.flash(*leaves, g, causal, window) * do).sum().backward()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == counts["flash_attention_bwd"] == 1
    _close(tuple(x.grad for x in leaves), got, torch.float32)


@pytest.mark.parametrize("hd,b,s,t,hq,hkv,causal", [
    (64, 2, 333, 333, 8, 8, False), (128, 1, 300, 520, 4, 2, False),
    (128, 1, 333, 333, 4, 2, True)])
def test_flash_f32_wide_backward_tf32_control(card, hd, b, s, t, hq, hkv,
                                              causal):
    """The control of the float32 wide backward's limits: the recompute
    twin with TF32 on misses 1e-4 (the kernel's limit in ``chip_smoke``)
    against the float64 oracle on every gradient, where the kernel, on
    the same inputs, stays within it."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = _bwd_inputs(card, s, hq, hkv, hd, torch.float32, b=b, t=t)
    g = hq // hkv
    o, lse = fa.flash_attention(q, k, v, g, causal, return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, g, causal)
    oracle = ref.attention_bwd_ref(*(x.double() for x in (q, k, v, o, lse,
                                                          do)), g, causal)
    assert max(_rel64(a, w) for a, w in zip(got, oracle, strict=True)) \
        <= 1e-4
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = [_rel64(a, w) for a, w in zip(
            ref.attention_bwd_ref(q, k, v, o, lse, do, g, causal), oracle,
            strict=True)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    assert min(control) > 1e-4, control


def _guarded_cuda_calls(card):
    from repro_torch.kernels import dct, freqca_fused, ssd_scan
    x = torch.randn(1, 64, 64, device=card, requires_grad=True)
    hist = torch.randn(1, 3, 64, 64, device=card)
    yield "band_split_spectral", lambda: dct.band_split_spectral(x, 0.0625)
    yield "token_basis_matmul", lambda: dct.token_basis_matmul(
        torch.eye(64, device=card), x)
    yield "band_split", lambda: dct.band_split(x, 0.0625)
    yield "freqca_predict_fused_spectral", \
        lambda: freqca_fused.freqca_predict_fused_spectral(
            x[:, :4], torch.zeros((64, 4), device=card), hist,
            torch.zeros((1, 3), device=card))
    yield "freqca_predict_fused", lambda: freqca_fused.freqca_predict_fused(
        x, hist[0][:, None], torch.ones(3, device=card),
        torch.tensor(0.5, device=card), 2)
    yield "ssd_chunk_scan", lambda: ssd_scan.ssd_chunk_scan(
        x.reshape(1, 64, 1, 64), x[..., 0].reshape(1, 64, 1).detach(),
        torch.ones(1, device=card), x[..., :16], x[..., :16], 64)


@pytest.mark.parametrize("name", ["band_split_spectral", "token_basis_matmul",
                                  "band_split",
                                  "freqca_predict_fused_spectral",
                                  "freqca_predict_fused", "ssd_chunk_scan"])
def test_guarded_wrappers_raise_under_grad_on_the_card(card, name):
    """A grad-requiring CUDA input to a kernel with no backward raises;
    it never returns a detached result.  No launch is counted."""
    call = dict(_guarded_cuda_calls(card))[name]
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("arch,window,pos", [
    ("yi-9b", 0, 23), ("yi-9b", 16, 524279), ("mamba2-370m", 0, 0)])
def test_decode_step_card_against_cpu(card, arch, window, pos):
    """The kernel-free decode step (``transformer.decode_step``, reduced
    config, float32) from one seeded non-empty cache, three tokens on
    the card against the CPU: logits and every cache leaf within 1e-4 of
    their largest magnitude (float32 sums in other orders; TF32 off), no
    kernel launched, the cache updated in place on its own device."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import blocks, common, transformer
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                              n_layers=4)
    params = common.init_params(transformer.lm_specs(cfg), seed=1,
                                device="cpu")
    gen = torch.Generator().manual_seed(2)
    caches = {"cpu": blocks.stack_cache_zeros(cfg, 2, 32, torch.float32,
                                              "cpu")}
    for group in caches["cpu"]:
        for c in group.values():
            for t in vars(c).values():
                if isinstance(t, torch.Tensor):
                    t.normal_(generator=gen)
            if hasattr(c, "index"):
                c.index = pos
    caches[card] = [{k: type(c)(**{f: (t.to(card, copy=True) if isinstance(
        t, torch.Tensor) else t) for f, t in vars(c).items()})
        for k, c in group.items()} for group in caches["cpu"]]
    toks = torch.randint(0, cfg.vocab_size, (2, 3), generator=gen)
    out = {}
    ops.reset_launch_counts()
    for dev, cache in caches.items():
        p = adamw.tree_map(lambda t, d=dev: t.to(d), params)
        with torch.no_grad():
            for i in range(toks.shape[1]):
                logits, back = transformer.decode_step(
                    p, toks[:, i:i + 1].to(dev), cache, cfg, window=window)
                assert back is cache
        out[dev] = logits
    assert not any(ops.launch_counts().values())
    pairs = [(out[card], out["cpu"])]
    for g_card, g_cpu in zip(caches[card], caches["cpu"], strict=True):
        for key in g_cpu:
            for f, t in vars(g_cpu[key]).items():
                if isinstance(t, torch.Tensor):
                    assert vars(g_card[key])[f].device.type == "cuda"
                    pairs.append((vars(g_card[key])[f], t))
                else:
                    assert vars(g_card[key])[f] == t == pos + 3
    for got, want in pairs:
        err = (got.cpu() - want).abs().max() / want.abs().max()
        assert float(err) <= 1e-4, float(err)


# the GQA groups of the fourteenth slice's configs, causal with S off the
# tiles: 3 at hd 64 (granite-moe-3b-a800m's 24/8), 4 at hd 128
# (phi3.5-moe), 7 (deepseek-coder-33b's 56/8), 12 (command-r-plus-104b's
# 96/8) and 16 (llama3-405b's 128/8).  The backward's pass (b) splits a
# group over blocks by halving it: 3 and 7 take one split, 12 four and 16
# sixteen at these sizes
_NEW_GROUPS = [
    (333, 6, 2, 64), (1100, 24, 8, 64), (300, 8, 2, 128),
    (333, 14, 2, 128), (300, 24, 2, 128), (333, 32, 2, 128),
    (700, 16, 1, 128),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,hq,hkv,hd", _NEW_GROUPS)
def test_flash_kernel_new_gqa_groups(card, dtype, s, hq, hkv, hd):
    q = torch.randn(2, s, hq, hd, device=card).to(dtype)
    k, v = (torch.randn(2, s, hkv, hd, device=card).to(dtype) for _ in "kv")
    ops.reset_launch_counts()
    got = ops.flash(q, k, v, hq // hkv, causal=True)
    assert ops.launch_counts()["flash_attention"] == 1
    _close((got,), (ref.attention_ref(q, k, v, hq // hkv, True),), dtype)


@pytest.mark.parametrize("s,hq,hkv,hd", _NEW_GROUPS)
def test_flash_bwd_kernel_new_gqa_groups(card, s, hq, hkv, hd):
    _check_flash_bwd(_bwd_inputs(card, s, hq, hkv, hd), hq // hkv, True, 0)


def _moe_case(dtype, cf, seed=0):
    """A reduced-width MoE layer (d 256, 8 experts top-2 of width 128)
    and two groups of 256 tokens, drawn on the CPU."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import common, moe
    base = configs.reduced(configs.get_config("granite-moe-3b-a800m"))
    cfg = dataclasses.replace(base, d_model=256, d_ff=128,
                              moe=dataclasses.replace(
                                  base.moe, n_experts=8, top_k=2,
                                  capacity_factor=cf))
    gen = torch.Generator().manual_seed(seed)
    params = common.init_params(moe.moe_specs(cfg), seed=seed, device="cpu")
    params["router"] = torch.randn(256, 8, generator=gen) / 16.0
    x = torch.randn(2, 256, 256, generator=gen).to(dtype)
    return cfg, params, x


def _route_of(params, x, cfg):
    from repro_torch.models import moe
    xt = x.reshape(-1, 256, x.shape[-1])
    _, _, mask, probs, _ = moe._routing(params, xt, cfg)
    return mask.cpu(), probs.cpu()


@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("cf", [16.0, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_card_against_cpu(card, impl, cf, dtype):
    """The MoE FFN (plain tensor code, no kernel) on the card against the
    CPU.  The routing first: δ, the largest difference of a router
    probability, and every token's k-th minus (k+1)-th probability must
    clear 4δ, then the masks are equal.  The output to TOL (float32 sums
    in other orders; bf16 expert products), the load-balance and z-loss
    1e-5 relative, the drop fraction equal; no kernel launched."""
    from repro_torch.models import moe
    cfg, params, x = _moe_case(dtype, cf)
    on_card = {k: v.to(card) for k, v in params.items()}
    m_cpu, p_cpu = _route_of(params, x, cfg)
    m_card, p_card = _route_of(on_card, x.to(card), cfg)
    delta = float((p_card - p_cpu).abs().max())
    top = torch.topk(p_cpu, cfg.moe.top_k + 1, dim=-1).values
    assert float((top[..., 1] - top[..., 2]).min()) > 4 * delta
    assert torch.equal(m_card, m_cpu)
    fn = {"einsum": moe.moe_ffn, "gather": moe.moe_ffn_gather}[impl]
    want, a_want = fn(params, x, cfg, group_size=256)
    ops.reset_launch_counts()
    got, a_got = fn(on_card, x.to(card), cfg, group_size=256)
    torch.cuda.synchronize()
    assert not any(ops.launch_counts().values())
    _close((got.cpu(),), (want,), dtype)
    for a, b in zip(a_got[:2], a_want[:2], strict=True):
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))
    assert float(a_got.drop_fraction) == float(a_want.drop_fraction)
    assert (float(a_want.drop_fraction) > 0) == (cf == 0.5)


@pytest.mark.parametrize("cf", [16.0, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_einsum_and_gather_agree_on_the_card(card, cf, dtype):
    """The two dispatches on the card: one routing, so the load-balance
    and z-losses are bitwise equal and the outputs differ by the sums'
    order only (float32 1e-5; bf16 TOL); the drop fractions equal in
    float32 and to the einsum form's bf16 sum in bf16."""
    from repro_torch.models import moe
    cfg, params, x = _moe_case(dtype, cf, seed=1)
    params = {k: v.to(card) for k, v in params.items()}
    x = x.to(card)
    ye, ae = moe.moe_ffn(params, x, cfg, group_size=256)
    yg, ag = moe.moe_ffn_gather(params, x, cfg, group_size=256)
    torch.cuda.synchronize()
    _close((yg,), (ye,), dtype)
    assert all(torch.equal(a, b) for a, b in zip(ae[:2], ag[:2],
                                                 strict=True))
    de, dg = float(ae.drop_fraction), float(ag.drop_fraction)
    assert (de == dg) if dtype == torch.float32 else \
        abs(de - dg) <= 2.0 ** -8


# heads of 128 (jamba's): the SSD wrappers run each as two heads of 64;
# (S, N, chunk) with x, B and C column slices of one conv output
_WIDE_HEADS = [(256, 64, 64), (1024, 128, 256), (4096, 128, 256),
               (2048, 64, 128)]
_SSD_CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _wide_head_inputs(card, dtype, s, n, b=2, h=3, p=128, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    xbc = (torch.randn((b, s, h * p + 2 * n), generator=g, device=card)
           * 0.5).to(dtype)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=g, device=card) - 2.0)
    a = -torch.exp(torch.randn((h,), generator=g, device=card) * 0.3)
    dy = torch.randn((b, s, h, p), generator=g, device=card).to(dtype)
    return x, dt, a, bm, cm, dy


def _ssd_close(got, want, dtype):
    """Per output, as max |kernel − plain| / max |plain|: y, dx, dB, dC
    as any output of the type; ddt 1e-4 and dA 1e-3 in both types
    (``tests/test_torch_ssd_bwd.py``'s card tolerances)."""
    names = ("y",) if len(got) == 1 else ("dx", "ddt", "dA", "dB", "dC")
    for name, g, w in zip(names, got, want, strict=True):
        tol = {"ddt": 1e-4, "dA": 1e-3}.get(name, _SSD_CARD_TOL[dtype])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        err = (g.float() - w.float()).abs().max() / w.float().abs().max()
        assert float(err) <= tol, (name, float(err))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,n,chunk", _WIDE_HEADS)
def test_ssd_kernels_at_head_dim_128(card, dtype, s, n, chunk):
    """Kernels 6 and 8 on heads of 128 against their plain versions at
    that width; one launch a call; kernel 8's two launches bitwise
    equal."""
    from repro_torch.kernels import ssd_scan
    x, dt, a, bm, cm, dy = _wide_head_inputs(card, dtype, s, n)
    ops.reset_launch_counts()
    y = ssd_scan.ssd_chunk_scan(x, dt, a, bm, cm, chunk)
    got = ssd_scan.ssd_chunk_scan_bwd(x, dt, a, bm, cm, dy, chunk)
    again = ssd_scan.ssd_chunk_scan_bwd(x, dt, a, bm, cm, dy, chunk)
    counts = ops.launch_counts()
    assert counts["ssd_chunk_scan"] == 1
    assert counts["ssd_chunk_scan_bwd"] == 2
    assert all(torch.equal(u, v) for u, v in zip(got, again, strict=True))
    _ssd_close((y,), (ref.ssd_chunk_scan_ref(x, dt, a, bm, cm, chunk),),
               dtype)
    _ssd_close(got, ref.ssd_chunk_scan_bwd_ref(x, dt, a, bm, cm, dy, chunk),
               dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_function_at_head_dim_128(card, dtype):
    """Autograd through ``ops.ssd`` on heads of 128, x, B and C column
    slices of one leaf as in the mamba2 block: one forward and one
    backward launch; the leaf's gradient holds the plain dx, dB, dC."""
    b, s, h, p, n = 2, 512, 3, 128, 128
    x, dt, a, bm, cm, dy = _wide_head_inputs(card, dtype, s, n, seed=1)
    xbc = torch.cat([x.reshape(b, s, h * p), bm, cm], dim=-1)
    leaves = [t.detach().clone().requires_grad_() for t in (xbc, dt, a)]
    xs, bs, cs = torch.split(leaves[0], [h * p, n, n], dim=-1)
    ops.reset_launch_counts()
    y = ops.ssd(xs.reshape(b, s, h, p), leaves[1], leaves[2], bs, cs, 256)
    y.backward(dy)
    counts = ops.launch_counts()
    assert counts["ssd_chunk_scan"] == counts["ssd_chunk_scan_bwd"] == 1
    gx, gb, gc = torch.split(leaves[0].grad, [h * p, n, n], dim=-1)
    _ssd_close((gx.reshape(b, s, h, p), leaves[1].grad, leaves[2].grad, gb,
                gc), ref.ssd_chunk_scan_bwd_ref(x, dt, a, bm, cm, dy, 256),
               dtype)


# the cross-attention form (seamless-m4t-medium's decoder into its
# memory): non-causal MHA at hd 64 with T != S, short and long memories
_CROSS_FORMS = [(200, 777), (1024, 4096), (333, 64), (4096, 2048)]


@pytest.mark.parametrize("s,t", _CROSS_FORMS)
def test_flash_kernels_at_the_cross_attention_form(card, s, t):
    """Kernel 3 in both types and kernel 7 (bf16) against their plain
    versions at S queries on T keys, non-causal, 16 heads of 64."""
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(1, s, 16, 64, device=card).to(dtype)
        k, v = (torch.randn(1, t, 16, 64, device=card).to(dtype)
                for _ in "kv")
        ops.reset_launch_counts()
        got = ops.flash(q, k, v)
        assert ops.launch_counts()["flash_attention"] == 1
        _close((got,), (ref.attention_ref(q, k, v),), dtype)
    _check_flash_bwd(_bwd_inputs(card, s, 16, 16, 64, b=1, t=t), 1, False,
                     0)


def test_cross_attention_routes_to_flash_on_the_card(card):
    """``attention.cross_attention`` at s·t >= 2048² launches kernel 3
    once on the card and agrees with the CPU's blockwise route (float32,
    1e-4: the projections' sums and the kernel's differ in order); in
    bf16 under autograd it launches kernel 7 once too; below the
    threshold it launches no kernel."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import attention, common
    cfg = dataclasses.replace(configs.reduced(configs.get_config(
        "seamless-m4t-medium")), d_model=256, n_heads=4, n_kv_heads=4,
        head_dim=64)
    params = common.init_params(attention.cross_attn_specs(cfg), seed=0,
                                device="cpu")
    x, mem = torch.randn(1, 1024, 256), torch.randn(1, 4096, 256)
    want = attention.cross_attention(params, x, mem, cfg)
    on_card = {k: v.to(card) for k, v in params.items()}
    ops.reset_launch_counts()
    with torch.no_grad():
        got = attention.cross_attention(on_card, x.to(card), mem.to(card),
                                        cfg)
    assert ops.launch_counts()["flash_attention"] == 1
    err = (got.cpu() - want).abs().max() / want.abs().max()
    assert float(err) <= 1e-4, float(err)
    bf = {k: v.to(torch.bfloat16) for k, v in on_card.items()}
    xl = x.to(card, torch.bfloat16).requires_grad_()
    ops.reset_launch_counts()
    attention.cross_attention(bf, xl, mem.to(card, torch.bfloat16),
                              cfg).float().sum().backward()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == counts["flash_attention_bwd"] == 1
    assert bool(torch.isfinite(xl.grad).all())
    ops.reset_launch_counts()
    with torch.no_grad():
        attention.cross_attention(on_card, x[:, :8].to(card), mem.to(card),
                                  cfg)
    assert not any(ops.launch_counts().values())


def test_cross_attention_routes_to_flash_at_hd32_on_the_card(card):
    """Reduced seamless-m4t-medium as the registry defines it (float32,
    4 query heads on 2 kv heads of 32): ``attention.cross_attention`` at
    s·t >= 2048² launches the float32 small-width forward once on the
    card and agrees with the CPU's blockwise route (1e-4); under autograd
    it launches the backward once, and the input's gradient agrees with
    the CPU's (1e-4)."""
    from repro_torch import configs
    from repro_torch.models import attention, common
    cfg = configs.reduced(configs.get_config("seamless-m4t-medium"))
    assert (cfg.head_dim, cfg.n_heads, cfg.n_kv_heads) == (32, 4, 2)
    params = common.init_params(attention.cross_attn_specs(cfg), seed=0,
                                device="cpu")
    x, mem = torch.randn(1, 1024, 128), torch.randn(1, 4096, 128)
    xl = x.clone().requires_grad_()
    want = attention.cross_attention(params, xl, mem, cfg)
    want.sum().backward()
    on_card = {k: v.to(card) for k, v in params.items()}
    xc = x.to(card).requires_grad_()
    ops.reset_launch_counts()
    got = attention.cross_attention(on_card, xc, mem.to(card), cfg)
    got.sum().backward()
    counts = ops.launch_counts()
    assert counts["flash_attention_f32"] == counts[
        "flash_attention_f32_bwd"] == 1
    assert sum(counts.values()) == 2
    for g, w in ((got.detach(), want.detach()), (xc.grad, xl.grad)):
        err = (g.cpu() - w).abs().max() / w.abs().max()
        assert float(err) <= 1e-4, float(err)


# float32 at head width 16 (dit-small's 8 heads), the ``flash_attention_f32``
# library: (B, S, T), a small S off the 128-row tiles, T != S, and S 1600
# (latent 80: ragged at 128 and at the 64-row tiles)
_F32_HD16 = [(2, 77, 77), (1, 300, 520), (2, 1600, 1600)]


@pytest.mark.parametrize("b,s,t", _F32_HD16)
def test_flash_f32_hd16_forward(card, b, s, t):
    """The float32 hd-16 forward with and without its log-sum-exp against
    ``attention_lse_ref`` (float32, TF32 off: 1e-5), the two outputs bit
    for bit, one launch each on the new library's counter."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, _ = _bwd_inputs(card, s, 8, 8, 16, torch.float32, b=b, t=t)
    ops.reset_launch_counts()
    out = fa.flash_attention(q, k, v)
    out2, lse = fa.flash_attention(q, k, v, return_lse=True)
    counts = ops.launch_counts()
    assert counts["flash_attention_f32"] == 2
    assert sum(counts.values()) == 2
    assert torch.equal(out, out2) and lse.shape == (b, 8, s)
    want_out, want_lse = ref.attention_lse_ref(q, k, v)
    _close((out, lse), (want_out, want_lse), torch.float32)


def _f32_bwd_oracle(q, k, v, o, lse, do):
    """The float32 hd-16 backward's float64 oracle (the recompute twin on
    float64 inputs, from the kernel's own o and lse) and the float32
    twin's error against it: ``(oracle, [dq, dk, dv] max rel err)``."""
    oracle = ref.attention_bwd_ref(*(x.double() for x in (q, k, v, o, lse,
                                                          do)))
    plain = ref.attention_bwd_ref(q, k, v, o, lse, do)
    return oracle, [_rel64(a, w) for a, w in zip(plain, oracle, strict=True)]


@pytest.mark.parametrize("b,s,t", _F32_HD16)
def test_flash_f32_hd16_backward(card, b, s, t):
    """dQ, dK, dV of the float32 hd-16 backward against the recompute twin
    on the same o and lse (float32: 1e-5) and against the float64 oracle
    within twice the float32 twin's own error (at least 1e-5), two
    launches bitwise equal, and ``ops.flash`` under autograd reaching
    both new kernels."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = _bwd_inputs(card, s, 8, 8, 16, torch.float32, b=b, t=t)
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    ops.reset_launch_counts()
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert ops.launch_counts()["flash_attention_f32_bwd"] == 2
    assert all(torch.equal(a, c) for a, c in zip(got, again, strict=True))
    _close(got, ref.attention_bwd_ref(q, k, v, o, lse, do), torch.float32)
    oracle, plain = _f32_bwd_oracle(q, k, v, o, lse, do)
    for a, w, p in zip(got, oracle, plain, strict=True):
        assert _rel64(a, w) <= max(TOL[torch.float32], 2 * p), (_rel64(a, w),
                                                              p)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ops.reset_launch_counts()
    (ops.flash(*leaves) * do).sum().backward()
    counts = ops.launch_counts()
    assert counts["flash_attention_f32"] == counts[
        "flash_attention_f32_bwd"] == 1
    _close(tuple(x.grad for x in leaves), got, torch.float32)


@pytest.mark.parametrize("b,s,t", [(2, 333, 333), (1, 300, 520)])
def test_flash_f32_hd16_backward_sharp_softmax(card, b, s, t):
    """The float32 hd-16 backward with q scaled so that the logits' std is
    ~80 (as ``test_flash_tf32_sharp_softmax`` for the forward), at a
    square shape and a ragged one (S != T, neither a multiple of the
    tiles).  There float32 itself carries ~1e-5, so dQ, dK and dV are
    held against the float64 oracle within 1e-5 or, where the float32
    twin is further off, within twice that twin's own error; the twin
    with TF32 on must miss the same limit on some gradient."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = _bwd_inputs(card, s, 8, 8, 16, torch.float32, b=b, t=t)
    q = q * 80.0
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    ops.reset_launch_counts()
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert ops.launch_counts()["flash_attention_f32_bwd"] == 1
    assert all(bool(torch.isfinite(a).all()) for a in got)
    oracle, plain = _f32_bwd_oracle(q, k, v, o, lse, do)
    tol = [max(TOL[torch.float32], 2 * p) for p in plain]
    errs = [_rel64(a, w) for a, w in zip(got, oracle, strict=True)]
    assert all(e <= lim for e, lim in zip(errs, tol)), (errs, tol)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = [_rel64(a, w) for a, w in zip(
            ref.attention_bwd_ref(q, k, v, o, lse, do), oracle, strict=True)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    assert any(c > lim for c, lim in zip(control, tol)), (control, tol)


@pytest.mark.parametrize("b,s,t", _F32_HD16[1:])
def test_flash_f32_hd16_backward_tf32_control(card, b, s, t):
    """The control of the float32 hd-16 backward's limits: the recompute
    twin with TF32 on misses 1e-4 (the kernel's limit in ``chip_smoke``)
    against the float64 oracle on every gradient, where the kernel, on
    the same inputs, stays within it.  Not at (2, 77, 77): there cuBLAS
    takes the twin's products off the tensor cores even with TF32
    allowed, so the control has nothing to show."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = _bwd_inputs(card, s, 8, 8, 16, torch.float32, b=b, t=t)
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    oracle, _ = _f32_bwd_oracle(q, k, v, o, lse, do)
    assert max(_rel64(a, w) for a, w in zip(got, oracle, strict=True)) \
        <= 1e-4
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = [_rel64(a, w) for a, w in zip(
            ref.attention_bwd_ref(q, k, v, o, lse, do), oracle, strict=True)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    assert min(control) > 1e-4, control


def test_flash_hd16_cuda_refuses_other_forms(card):
    """At head widths 16 and 32 a CUDA call in bf16 launches the small
    library's kernel in every form (non-causal, causal, GQA) and matches
    the plain version (bf16 2e-2), as the float32 causal and GQA forms
    do; a head width of 256 raises, naming ``ROADMAP.md`` (queued
    there), and launches nothing.  Nothing reaches the plain version."""
    from repro_torch.kernels import flash_attention as fa
    for hd in (16, 32):
        q, k, v, _ = _bwd_inputs(card, 128, 8, 8, hd, torch.float32)
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        ops.reset_launch_counts()
        for form in ((1, False), (1, True), (2, False)):
            g, causal = form
            kf, vf = (x[:, :, :8 // g].contiguous() for x in (kb, vb))
            _close((fa.flash_attention(qb, kf, vf, g, causal),),
                   (ref.attention_ref(qb, kf, vf, g, causal),),
                   torch.bfloat16)
        assert ops.launch_counts()["flash_attention_f32"] == 3
        ops.flash(q, k, v, causal=True)
        ops.flash(q, k[:, :, :4], v[:, :, :4], 2)
        assert ops.launch_counts()["flash_attention_f32"] == 5
    ops.reset_launch_counts()
    wide = torch.zeros((1, 64, 2, 256), device=card)
    with pytest.raises(ValueError, match="head_dim 256.*ROADMAP"):
        fa.flash_attention(wide, wide, wide)
    assert not any(ops.launch_counts().values())


# float32 at the small head widths in every form (``flash_attention_f32``:
# the forward template at 16 and 32, the two-pass backward): (B, S, T,
# Hq, Hkv, hd, causal, window) at the reference's kernel tests' forms
# (hd 16 causal and window 24 at GQA 4/2 and 6/2; hd 32 causal GQA 4/2)
# and the reduced configs' (hd 32 causal GQA 4/2, non-causal and cross
# with T != S), ragged against the 64-row tiles, T shorter than a tile
_F32_SMALL_FORMS = [
    (2, 64, 64, 4, 2, 16, True, 0),
    (2, 128, 128, 8, 8, 16, True, 24),
    (2, 64, 64, 6, 2, 16, True, 24),
    (1, 333, 333, 6, 2, 16, False, 40),     # non-causal window, GQA
    (1, 64, 64, 4, 2, 32, True, 0),
    (2, 300, 300, 4, 2, 32, True, 0),       # reduced yi-9b's form, ragged
    (1, 520, 520, 4, 4, 32, True, 100),     # causal window, MHA
    (2, 260, 390, 4, 2, 32, False, 0),      # seamless's cross, T != S
    (1, 300, 40, 4, 2, 32, False, 0),       # T shorter than a key tile
    (1, 1000, 1000, 8, 2, 32, False, 0),    # non-causal GQA, 16 tiles
]


@pytest.mark.parametrize("b,s,t,hq,hkv,hd,causal,window", _F32_SMALL_FORMS)
def test_flash_f32_small_forms(card, b, s, t, hq, hkv, hd, causal, window):
    """Kernels 3 and 7 in float32 at head width 16 or 32 in every form:
    the forward with and without its log-sum-exp against
    ``attention_lse_ref`` (float32, TF32 off: 1e-5), equal with and
    without the LSE; the backward against the recompute twin on the same
    o and lse (1e-5) and against the float64 oracle within twice the
    float32 twin's own error (at least 1e-5); two backward launches
    bitwise equal; ``ops.flash`` under autograd reaching both."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = _bwd_inputs(card, s, hq, hkv, hd, torch.float32, b=b,
                              t=t)
    g = hq // hkv
    ops.reset_launch_counts()
    out = fa.flash_attention(q, k, v, g, causal, window)
    o, lse = fa.flash_attention(q, k, v, g, causal, window, return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, g, causal, window)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, g, causal, window)
    counts = ops.launch_counts()
    assert counts["flash_attention_f32"] == counts[
        "flash_attention_f32_bwd"] == 2
    assert sum(counts.values()) == 4
    assert torch.equal(out, o)
    assert all(torch.equal(a, c) for a, c in zip(got, again, strict=True))
    _close((o, lse), ref.attention_lse_ref(q, k, v, g, causal, window),
           torch.float32)
    _close(got, ref.attention_bwd_ref(q, k, v, o, lse, do, g, causal,
                                      window), torch.float32)
    oracle = ref.attention_bwd_ref(*(x.double() for x in (q, k, v, o, lse,
                                                          do)), g, causal,
                                   window)
    plain = ref.attention_bwd_ref(q, k, v, o, lse, do, g, causal, window)
    for a, w, pl in zip(got, oracle, plain, strict=True):
        lim = max(TOL[torch.float32], 2 * _rel64(pl, w))
        assert _rel64(a, w) <= lim, (_rel64(a, w), lim)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ops.reset_launch_counts()
    (ops.flash(*leaves, g, causal, window) * do).sum().backward()
    counts = ops.launch_counts()
    assert counts["flash_attention_f32"] == counts[
        "flash_attention_f32_bwd"] == 1
    _close(tuple(x.grad for x in leaves), got, torch.float32)


@pytest.mark.parametrize("hd,hq,hkv,causal,window", [
    (32, 4, 2, True, 0), (32, 4, 2, False, 0), (16, 6, 2, True, 24)])
def test_flash_f32_small_forms_sharp_softmax(card, hd, hq, hkv, causal,
                                             window):
    """The backward at sharp logits (q scaled so that their std is ~80,
    as ``test_flash_f32_hd16_backward_sharp_softmax``), ragged (1, 300
    queries on 520 keys non-causal; 333 causal): dQ, dK and dV against
    the float64 oracle within twice the float32 twin's own error (at
    least 1e-5); the twin with TF32 on must miss that limit on some
    gradient.  (The forward at sharp logits: ``test_flash_tf32_sharp_
    softmax``.)"""
    from repro_torch.kernels import flash_attention as fa
    s, t = (300, 520) if not causal else (333, 333)
    q, k, v, do = _bwd_inputs(card, s, hq, hkv, hd, torch.float32, b=1, t=t)
    q = q * 80.0
    g = hq // hkv
    o, lse = fa.flash_attention(q, k, v, g, causal, window, return_lse=True)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, g, causal, window)
    assert all(bool(torch.isfinite(a).all()) for a in got)
    oracle = ref.attention_bwd_ref(*(x.double() for x in (q, k, v, o, lse,
                                                          do)), g, causal,
                                   window)
    plain = ref.attention_bwd_ref(q, k, v, o, lse, do, g, causal, window)
    lims = [max(TOL[torch.float32], 2 * _rel64(pl, w))
            for pl, w in zip(plain, oracle, strict=True)]
    errs = [_rel64(a, w) for a, w in zip(got, oracle, strict=True)]
    assert all(e <= lim for e, lim in zip(errs, lims)), (errs, lims)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = ref.attention_bwd_ref(q, k, v, o, lse, do, g, causal,
                                        window)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    miss = [_rel64(c, w) for c, w in zip(control, oracle, strict=True)]
    assert any(m > lim for m, lim in zip(miss, lims)), (miss, lims)


# kernels 6 and 8 at the small widths: (S, P, N, chunk) at the reduced
# configs' (heads of 32, state 16, chunks of 16), the reference's kernel
# tests' (heads of 16, state 8, chunks of 16 and 32), and the new tiles
# beside the old width (heads of 64 in chunks of 16 and 32; heads of 16
# in chunks of 64 and 128)
_SSD_SMALL = [(2048, 32, 16, 16), (512, 16, 8, 16), (256, 16, 8, 32),
              (512, 64, 16, 16), (384, 64, 32, 32), (512, 16, 24, 64),
              (1024, 32, 128, 128), (96, 32, 16, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,p,n,chunk", _SSD_SMALL)
def test_ssd_kernels_at_small_widths(card, dtype, s, p, n, chunk):
    """Kernels 6 and 8 at heads of 16, 32 and 64 in chunks of 16, 32 and
    multiples of 64, x, B and C column slices of one conv output, against
    their plain versions (``_ssd_close``); one launch a call; kernel 8's
    two launches bitwise equal; ``ops.ssd`` under autograd one forward
    and one backward launch."""
    from repro_torch.kernels import ssd_scan
    x, dt, a, bm, cm, dy = _wide_head_inputs(card, dtype, s, n, h=4, p=p)
    ops.reset_launch_counts()
    y = ssd_scan.ssd_chunk_scan(x, dt, a, bm, cm, chunk)
    got = ssd_scan.ssd_chunk_scan_bwd(x, dt, a, bm, cm, dy, chunk)
    again = ssd_scan.ssd_chunk_scan_bwd(x, dt, a, bm, cm, dy, chunk)
    counts = ops.launch_counts()
    assert counts["ssd_chunk_scan"] == 1
    assert counts["ssd_chunk_scan_bwd"] == 2
    assert all(torch.equal(u, v) for u, v in zip(got, again, strict=True))
    _ssd_close((y,), (ref.ssd_chunk_scan_ref(x, dt, a, bm, cm, chunk),),
               dtype)
    _ssd_close(got, ref.ssd_chunk_scan_bwd_ref(x, dt, a, bm, cm, dy, chunk),
               dtype)
    leaves = [t.detach().clone().requires_grad_()
              for t in (x, dt, a, bm, cm)]
    ops.reset_launch_counts()
    ops.ssd(*leaves, chunk).backward(dy)
    counts = ops.launch_counts()
    assert counts["ssd_chunk_scan"] == counts["ssd_chunk_scan_bwd"] == 1
    _ssd_close(tuple(t.grad for t in leaves), got, dtype)


def test_ssd_cuda_refuses_the_forms_still_queued(card):
    """A head of 48 and a chunk of 8 now launch the kernel on the card
    and match the plain version; a chunk of 512 and a d_state of 136
    raise, naming ``ROADMAP.md``, and launch nothing."""
    from repro_torch.kernels import ssd_scan
    ops.reset_launch_counts()
    for p, chunk in ((48, 16), (32, 8)):
        x, dt, a, bm, cm, _ = _wide_head_inputs(card, torch.float32, 64, 16,
                                                h=2, p=p)
        _ssd_close((ssd_scan.ssd_chunk_scan(x, dt, a, bm, cm, chunk),),
                   (ref.ssd_chunk_scan_ref(x, dt, a, bm, cm, chunk),),
                   torch.float32)
    assert ops.launch_counts()["ssd_chunk_scan"] == 2
    ops.reset_launch_counts()
    for s, n, chunk in ((1024, 16, 512), (64, 136, 16)):
        x, dt, a, bm, cm, _ = _wide_head_inputs(card, torch.float32, s, n,
                                                h=2, p=32)
        with pytest.raises(ValueError, match="ROADMAP"):
            ssd_scan.ssd_chunk_scan(x, dt, a, bm, cm, chunk)
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("arch,seq", [("yi-9b", 2048),
                                      ("mamba2-370m", 128)])
def test_reduced_launcher_on_the_card(card, arch, seq):
    """``launch.train.main`` with ``--reduced`` and no ``--device`` trains
    on the card: reduced yi-9b at S 2048 through kernels 3 and 7 in
    float32 at head width 32 (causal GQA 4/2), reduced mamba2-370m at the
    launcher's default S 128 through kernels 6 and 8 at heads of 32 in
    chunks of 16."""
    from repro_torch.launch import train
    ops.reset_launch_counts()
    train.main(["--arch", arch, "--reduced", "--steps", "2", "--batch", "1",
                "--seq", str(seq)])
    counts = ops.launch_counts()
    want = (("flash_attention_f32", "flash_attention_f32_bwd")
            if arch == "yi-9b" else ("ssd_chunk_scan", "ssd_chunk_scan_bwd"))
    assert all(counts[k] > 0 for k in want), counts


# the float32 forward on the TF32 tensor cores (flash_fwd_tf32.cuh, three
# products of hi + lo splits): 128 queries a block, 16 a warp, key tiles
# of 64 at hd 16 and 64, of 32 at hd 128.  (B, S, T, Hq, Hkv, hd, causal,
# window): S and T off every tile edge, T shorter than one key tile, and
# at 64 and 128 the causal, window and GQA forms (those at 16 and 32:
# ``_F32_SMALL_FORMS``)
_TF32_FWD_FORMS = [
    (2, 200, 200, 8, 8, 16, False, 0),
    (1, 130, 40, 8, 8, 16, False, 0),       # T shorter than a key tile
    (2, 333, 77, 4, 4, 64, False, 0),
    (1, 300, 20, 4, 4, 128, False, 0),      # T shorter than a tile of 32
    (2, 333, 333, 8, 2, 64, True, 0),       # causal GQA
    (2, 300, 300, 4, 1, 128, True, 0),
    (1, 520, 520, 8, 2, 128, True, 100),    # causal window, GQA
    (1, 400, 400, 4, 4, 64, False, 90),     # non-causal window
    (2, 260, 390, 4, 2, 128, False, 0),     # T != S, GQA
]


@pytest.mark.parametrize("b,s,t,hq,hkv,hd,causal,window", _TF32_FWD_FORMS)
def test_flash_tf32_forward_forms(card, b, s, t, hq, hkv, hd, causal,
                                  window):
    """The float32 forward with and without its log-sum-exp against
    ``attention_lse_ref`` (float32, TF32 off: 1e-5), the output equal
    with and without the LSE, two launches bitwise equal, one launch a
    call on its counter."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, _ = _bwd_inputs(card, s, hq, hkv, hd, torch.float32, b=b, t=t)
    g = hq // hkv
    counter = "flash_attention_f32" if hd == 16 else "flash_attention"
    ops.reset_launch_counts()
    out = fa.flash_attention(q, k, v, g, causal, window)
    again = fa.flash_attention(q, k, v, g, causal, window)
    out2, lse = fa.flash_attention(q, k, v, g, causal, window,
                                   return_lse=True)
    assert ops.launch_counts()[counter] == 3
    assert torch.equal(out, again) and torch.equal(out, out2)
    want_out, want_lse = ref.attention_lse_ref(q, k, v, g, causal, window)
    _close((out, lse), (want_out, want_lse), torch.float32)


def _rel64(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


@pytest.mark.parametrize("hd,hq,hkv,causal", [(16, 8, 8, False),
                                              (64, 8, 2, True),
                                              (128, 32, 4, True),
                                              (32, 4, 2, True),
                                              (32, 4, 2, False)])
def test_flash_tf32_sharp_softmax(card, hd, hq, hkv, causal):
    """float32 with q scaled so that the logits' std is ~80 (as
    ``test_flash_kernel_sharp_softmax`` in bf16).  There float32 itself
    carries ~1e-5: a logit near 300 puts its own rounding into the
    exponent.  So the kernel is held against the float64 oracle (the
    plain version on float64 inputs) within 1e-5 or, where the float32
    plain version is further off, within twice that version's own error;
    the plain version with TF32 on must miss the same limit."""
    q = torch.randn(2, 333, hq, hd, device=card) * 80.0
    k, v = (torch.randn(2, 333, hkv, hd, device=card) for _ in "kv")
    g = hq // hkv
    ops.reset_launch_counts()
    got = ops.flash(q, k, v, g, causal=causal)
    assert sum(ops.launch_counts().values()) == 1
    oracle = ref.attention_ref(*(x.double() for x in (q, k, v)), g, causal)
    plain = _rel64(ref.attention_ref(q, k, v, g, causal), oracle)
    tol = max(TOL[torch.float32], 2 * plain)
    assert _rel64(got, oracle) <= tol, (_rel64(got, oracle), plain)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = _rel64(ref.attention_ref(q, k, v, g, causal), oracle)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    assert control > tol, (control, tol)


# the forms slice: bf16 at head widths 16 and 32 and every head width up
# to 128 (kernels 3 and 7), the SSD scan at any chunk, head and state
# (kernels 6 and 8).  (dtype, B, S, T, Hq, Hkv, hd, causal, window): the
# reference's dtype test (bf16 hd 32 causal GQA 4/2 at S 64), bf16 at hd
# 16 and 32 in the masked forms with ragged S and T, hd 24 and 8 on the
# small instances, 20 and 6 through the wrapper's zero-padded copy, 40,
# 72, 96, 100 and 104 on the wide ones (DiT-XL's 72, Phi-3's 96)
_ANY_WIDTH = [
    (torch.bfloat16, 1, 64, 64, 4, 2, 32, True, 0),
    (torch.bfloat16, 2, 333, 333, 8, 2, 16, True, 24),
    (torch.bfloat16, 1, 300, 520, 4, 4, 32, False, 0),
    (torch.bfloat16, 2, 200, 200, 6, 2, 24, True, 0),
    (torch.float32, 2, 200, 200, 6, 2, 24, True, 0),
    (torch.float32, 1, 300, 300, 4, 4, 8, False, 0),
    (torch.bfloat16, 1, 130, 130, 4, 2, 20, True, 0),
    (torch.float32, 1, 130, 130, 4, 2, 6, True, 0),
    (torch.bfloat16, 2, 1024, 1024, 16, 16, 72, False, 0),
    (torch.float32, 2, 1024, 1024, 16, 16, 72, False, 0),
    (torch.bfloat16, 1, 1024, 1024, 8, 8, 96, True, 0),
    (torch.bfloat16, 1, 520, 520, 8, 2, 40, True, 100),
    (torch.float32, 1, 520, 520, 8, 2, 40, True, 100),
    (torch.bfloat16, 2, 260, 390, 4, 2, 104, False, 0),
    (torch.float32, 2, 260, 390, 4, 2, 100, False, 0),
]


@pytest.mark.parametrize("dtype,b,s,t,hq,hkv,hd,causal,window", _ANY_WIDTH)
def test_flash_kernels_at_every_width(card, dtype, b, s, t, hq, hkv, hd,
                                      causal, window):
    """The forward (with its log-sum-exp) on the instance above hd
    against the plain version, and the backward: bf16 against the
    recompute twin at 2e-2, two launches bitwise equal; float32 against
    the float64 oracle within max(1e-5, twice the float32 twin's own
    error), the forward with a TF32 control that must miss that limit
    where cuBLAS takes TF32 for the plain version's products (S of 200
    and more, hd of 16 and more).  One launch a call on the library of
    its instance."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = _bwd_inputs(card, s, hq, hkv, hd, dtype, b=b, t=t)
    g = hq // hkv
    small = hd <= fa.SMALL_HEAD_DIM
    lib = "flash_attention_f32" if small else "flash_attention"
    ops.reset_launch_counts()
    out, lse = fa.flash_attention(q, k, v, g, causal, window,
                                  return_lse=True)
    assert ops.launch_counts()[lib] == 1
    want_out, want_lse = ref.attention_lse_ref(q, k, v, g, causal, window)
    if dtype == torch.bfloat16:
        _close((out,), (want_out,), dtype)
    else:
        oracle = ref.attention_ref(*(x.double() for x in (q, k, v)), g,
                                   causal, window)
        lim = max(TOL[dtype], 2 * _rel64(want_out, oracle))
        assert _rel64(out, oracle) <= lim, (_rel64(out, oracle), lim)
        if s >= 200 and hd >= 16:
            allow = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                control = _rel64(ref.attention_ref(q, k, v, g, causal,
                                                   window), oracle)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = allow
            assert control > lim, (control, lim)
    assert float((lse - want_lse).abs().max()) <= 1e-5 * float(
        want_lse.abs().max())
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, g, causal, window)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, g, causal, window)
    assert ops.launch_counts()[lib + "_bwd"] == 2
    assert all(torch.equal(a, c) for a, c in zip(got, again, strict=True))
    if dtype == torch.bfloat16:
        _close(got, ref.attention_bwd_ref(q, k, v, out, lse, do, g, causal,
                                          window), dtype)
        return
    oracle = ref.attention_bwd_ref(*(x.double() for x in (q, k, v, out, lse,
                                                          do)), g, causal,
                                   window)
    plain = ref.attention_bwd_ref(q, k, v, out, lse, do, g, causal, window)
    for a, p, w in zip(got, plain, oracle, strict=True):
        assert _rel64(a, w) <= max(TOL[dtype], 2 * _rel64(p, w))


def test_flash_bf16_small_autograd(card):
    """``ops.flash`` under autograd in bf16 at hd 32, causal GQA 4/2 (the
    reference's dtype test's form): one forward and one backward launch
    of the small library, the gradients equal to the backward wrapper's
    on the same o and lse."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = _bwd_inputs(card, 64, 4, 2, 32, b=1)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ops.reset_launch_counts()
    out = ops.flash(*leaves, 2, causal=True)
    out.backward(do)
    counts = ops.launch_counts()
    assert counts["flash_attention_f32"] == counts[
        "flash_attention_f32_bwd"] == 1 and sum(counts.values()) == 2
    o, lse = fa.flash_attention(q, k, v, 2, True, return_lse=True)
    want = fa.flash_attention_bwd(q, k, v, o, lse, do, 2, True)
    assert all(torch.equal(x.grad, w) for x, w in zip(leaves, want,
                                                      strict=True))


# the bf16 small widths on the bf16 tensor cores (flash_bf16_small.cuh):
# (B, S, T, Hq, Hkv, causal, window) of four forms, each at head widths
# 16, 24 (instance 32, a zero-filled column block) and 32: non-causal
# MHA, causal MHA on a ragged S, causal GQA 4/2 with a window of 24, and
# cross attention (S != T, both ragged)
_BF16_SMALL_FORMS = {"mha": (2, 256, 256, 4, 4, False, 0),
                     "causal": (1, 300, 300, 4, 4, True, 0),
                     "gqa window": (1, 333, 333, 4, 2, True, 24),
                     "cross": (1, 200, 520, 4, 2, False, 0)}


@pytest.mark.parametrize("hd", [16, 24, 32])
@pytest.mark.parametrize("form", list(_BF16_SMALL_FORMS))
def test_flash_bf16_small_forms(card, hd, form):
    """The bf16 forward (with its log-sum-exp) and backward at the small
    widths against the plain versions: the output and each gradient at
    2e-2 (``ref.attention_lse_ref`` / ``attention_bwd_ref`` round P and
    dS to bf16 where the kernels do), the log-sum-exp at 1e-5 of its
    largest; one forward launch, two backward launches bitwise equal."""
    from repro_torch.kernels import flash_attention as fa
    b, s, t, hq, hkv, causal, window = _BF16_SMALL_FORMS[form]
    q, k, v, do = _bwd_inputs(card, s, hq, hkv, hd, b=b, t=t)
    form_ = (hq // hkv, causal, window)
    ops.reset_launch_counts()
    out, lse = fa.flash_attention(q, k, v, *form_, return_lse=True)
    want_out, want_lse = ref.attention_lse_ref(q, k, v, *form_)
    _close((out,), (want_out,), torch.bfloat16)
    assert float((lse - want_lse).abs().max()) <= 1e-5 * float(
        want_lse.abs().max())
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, *form_)
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, *form_)
    counts = ops.launch_counts()
    assert counts["flash_attention_f32"] == 1
    assert counts["flash_attention_f32_bwd"] == 2
    assert all(torch.equal(a, c) for a, c in zip(got, again, strict=True))
    _close(got, ref.attention_bwd_ref(q, k, v, out, lse, do, *form_),
           torch.bfloat16)


@pytest.mark.parametrize("hd,hq,hkv,causal", [(16, 8, 8, False),
                                              (32, 4, 2, True)])
def test_flash_bf16_small_float64_guard(card, hd, hq, hkv, causal):
    """The bf16 kernels against the float64 oracle (the plain versions on
    float64 inputs, which round nothing): the output, and each gradient
    from the kernel's own o and lse, no further from it than twice the
    bf16 plain version's own error."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = _bwd_inputs(card, 1024, hq, hkv, hd)
    form = (hq // hkv, causal)
    out, lse = fa.flash_attention(q, k, v, *form, return_lse=True)
    oracle = ref.attention_ref(*(x.double() for x in (q, k, v)), *form)
    twin = _rel64(ref.attention_ref(q, k, v, *form), oracle)
    assert _rel64(out, oracle) <= 2 * twin, (_rel64(out, oracle), twin)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, *form)
    oracle = ref.attention_bwd_ref(*(x.double() for x in (q, k, v, out,
                                                          lse, do)), *form)
    plain = ref.attention_bwd_ref(q, k, v, out, lse, do, *form)
    for a, p, w in zip(got, plain, oracle, strict=True):
        assert _rel64(a, w) <= 2 * _rel64(p, w), (_rel64(a, w),
                                                   _rel64(p, w))


def _sharp_draw(card, seed, b, s, t, hq=8, hkv=8, causal=False, window=0,
                hd=16):
    """q, k, v, dO of one seeded draw at head width ``hd``, q scaled so
    that the scaled logits' std is ~80."""
    g = torch.Generator(device=card).manual_seed(seed)
    q, do = (torch.randn(b, s, hq, hd, generator=g, device=card)
             for _ in range(2))
    k, v = (torch.randn(b, t, hkv, hd, generator=g, device=card)
            for _ in range(2))
    return q * 80.0, k, v, do


@pytest.mark.parametrize("b,s,t", [(2, 333, 333), (1, 300, 520)])
def test_flash_f32_hd16_backward_sharp_softmax_draws(card, b, s, t):
    """``test_flash_f32_hd16_backward_sharp_softmax``'s rule on 60 seeded
    draws: dQ, dK and dV against the float64 oracle within max(1e-5,
    twice the float32 twin's own error) on every draw (the tensor cores'
    truncated S sums missed it on 3 of 60 at (2, 333, 333) before S went
    to the FMA units)."""
    from repro_torch.kernels import flash_attention as fa
    misses = []
    for seed in range(60):
        q, k, v, do = _sharp_draw(card, seed, b, s, t)
        o, lse = fa.flash_attention(q, k, v, return_lse=True)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do)
        oracle, plain = _f32_bwd_oracle(q, k, v, o, lse, do)
        errs = [_rel64(a, w) for a, w in zip(got, oracle, strict=True)]
        if any(e > max(TOL[torch.float32], 2 * p)
               for e, p in zip(errs, plain)):
            misses.append((seed, errs, plain))
    assert not misses, misses


@pytest.mark.parametrize("hd,b,s,t,hq,hkv,causal,window", [
    (64, 2, 333, 333, 8, 8, False, 0), (64, 1, 333, 333, 4, 2, True, 24),
    (128, 1, 300, 520, 4, 2, False, 0), (128, 1, 333, 333, 4, 2, True, 0)])
def test_flash_f32_wide_backward_sharp_softmax_draws(card, hd, b, s, t, hq,
                                                     hkv, causal, window):
    """The float32 wide backward (head widths 64 and 128) at sharp logits
    (q x 80) on 60 seeded draws: dQ, dK and dV against the float64 oracle
    within max(1e-5, twice the float32 twin's own error) on every draw,
    the logits recomputed on the tensor cores as the forward computes
    them; and on the first draw the twin with TF32 on misses that limit
    on some gradient (the control)."""
    from repro_torch.kernels import flash_attention as fa
    g = hq // hkv
    misses = []
    for seed in range(60):
        q, k, v, do = _sharp_draw(card, seed, b, s, t, hq, hkv, hd=hd)
        o, lse = fa.flash_attention(q, k, v, g, causal, window,
                                    return_lse=True)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, g, causal, window)
        oracle = ref.attention_bwd_ref(*(x.double() for x in (
            q, k, v, o, lse, do)), g, causal, window)
        plain = ref.attention_bwd_ref(q, k, v, o, lse, do, g, causal, window)
        lims = [max(TOL[torch.float32], 2 * _rel64(p, w))
                for p, w in zip(plain, oracle, strict=True)]
        errs = [_rel64(a, w) for a, w in zip(got, oracle, strict=True)]
        if not all(bool(torch.isfinite(a).all()) for a in got) or any(
                e > lim for e, lim in zip(errs, lims)):
            misses.append((seed, errs, lims))
        if seed == 0:
            allow = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                control = [_rel64(c, w) for c, w in zip(
                    ref.attention_bwd_ref(q, k, v, o, lse, do, g, causal,
                                          window), oracle, strict=True)]
            finally:
                torch.backends.cuda.matmul.allow_tf32 = allow
            assert any(c > lim for c, lim in zip(control, lims)), (control,
                                                                   lims)
    assert not misses, (len(misses), misses[:3])


def test_flash_f32_hd16_window_sharp_softmax_draws(card):
    """The float32 hd-16 forward with a window of 24 (causal GQA 4/2, S
    333) at sharp logits on 60 seeded draws: the output against the
    float64 oracle within max(1e-5, twice the float32 plain version's own
    error) on every draw (the scaled masked logits' rounding missed it on
    3 of 60 before the softmax kept s·scale − m in one rounding)."""
    from repro_torch.kernels import flash_attention as fa
    misses = []
    for seed in range(60):
        q, k, v, _ = _sharp_draw(card, seed, 1, 333, 333, hq=4, hkv=2)
        got = fa.flash_attention(q, k, v, 2, True, 24)
        oracle = ref.attention_ref(*(x.double() for x in (q, k, v)), 2,
                                   True, 24)
        lim = max(TOL[torch.float32],
                  2 * _rel64(ref.attention_ref(q, k, v, 2, True, 24),
                             oracle))
        if _rel64(got, oracle) > lim:
            misses.append((seed, _rel64(got, oracle), lim))
    assert not misses, misses


# (S, P, N, chunk): the reference's chunk of 8, chunks of 24 and 48, a
# head of 48 and of 40, states of 12 and 20, a chunk of 100 at S 200
_SSD_FORMS = [(32, 16, 8, 8), (96, 16, 8, 24), (96, 32, 16, 48),
              (256, 48, 16, 64), (480, 40, 20, 24), (256, 64, 12, 256),
              (200, 32, 16, 100)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,p,n,chunk", _SSD_FORMS)
def test_ssd_kernels_at_every_form(card, dtype, s, p, n, chunk):
    """Kernels 6 and 8 at the forms no instance has (run on the
    instances through ``ssd_scan.kernel_form``'s zero-padded copy)
    against their plain versions at ``_SSD_CARD_TOL`` (ddt 1e-4, dA
    1e-3), two backward launches bitwise equal, one launch of each a
    call."""
    from repro_torch.kernels import ssd_scan
    x, dt, a, bm, cm, dy = _wide_head_inputs(card, dtype, s, n, h=3, p=p)
    ops.reset_launch_counts()
    y = ssd_scan.ssd_chunk_scan(x, dt, a, bm, cm, chunk)
    got = ssd_scan.ssd_chunk_scan_bwd(x, dt, a, bm, cm, dy, chunk)
    again = ssd_scan.ssd_chunk_scan_bwd(x, dt, a, bm, cm, dy, chunk)
    counts = ops.launch_counts()
    assert counts["ssd_chunk_scan"] == 1 and counts[
        "ssd_chunk_scan_bwd"] == 2
    assert all(torch.equal(g, w) for g, w in zip(got, again, strict=True))
    _ssd_close((y,), (ref.ssd_chunk_scan_ref(x, dt, a, bm, cm, chunk),),
               dtype)
    _ssd_close(got, ref.ssd_chunk_scan_bwd_ref(x, dt, a, bm, cm, dy, chunk),
               dtype)


def _example(name: str):
    """``examples/<name>.py``, imported by its path."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the quickstart's sampled latents, card against CPU from the same
# parameters and x0 (relative L2; float32 with TF32 off on both sides):
# chip_smoke's limit over 50 steps, EXAMPLES_TOL["latents"]
_EXAMPLE_TOL = 5e-6


def test_quickstart_example_on_card(card):
    """The quickstart twin's ``run`` at 4 train and 10 sampling steps on
    the card: kernels 1 and 2 launched (a band split on each of the 4
    full steps, a fused step on each of the 6 cached ones) and nothing
    else; its samples against the CPU's from the same parameters."""
    from repro_torch import configs
    from repro_torch.optim import adamw
    mod = _example("torch_quickstart")
    ops.reset_launch_counts()
    res = mod.run(train_steps=4, n_steps=10)
    counts = ops.launch_counts()
    assert counts["band_split_spectral"] == 4
    assert counts["freqca_predict_fused_spectral"] == 6
    assert sum(counts.values()) == 10
    params = adamw.tree_map(lambda p: p.detach().cpu(), res["params"])
    want = mod.sample(params, configs.get_config("dit-small"), n_steps=10,
                      device="cpu")
    assert (res["full_steps"], res["freqca_steps"]) == (
        want["full_steps"], want["freqca_steps"]) == (10, 4)
    for key in ("x_full", "x_freqca"):
        got = res[key].cpu()
        assert torch.isfinite(got).all()
        assert float((got - want[key]).norm() / want[key].norm()) \
            <= _EXAMPLE_TOL


def test_fft_cache_kernels_at_the_edit_examples_shape(card):
    """Kernels 1 and 2 in the fft form on the float32 CRF of the edit
    example, [2, 256, 128] (m 17), the high ring of 3."""
    x = torch.randn(2, 256, 128, device=card)
    ops.reset_launch_counts()
    low, high = ops.band_split_spectral(x, 0.0625, "fft")
    _close((low, high), ref.band_split_spectral_ref(x, 0.0625, "fft"),
           torch.float32)
    assert low.shape == (2, 17, 128)
    synth = frequency.low_band_basis(256, 0.0625, "fft", device=card).T
    hist = torch.randn(2, 3, 256, 128, device=card)
    w = torch.randn(2, 3, device=card)
    got = ops.freqca_predict_spectral(low, synth, hist, w)
    _close((got,), (ref.freqca_predict_spectral_ref(low, synth, hist, w),),
           torch.float32)
    assert ops.launch_counts()["band_split_spectral"] == 1
    assert ops.launch_counts()["freqca_predict_fused_spectral"] == 1

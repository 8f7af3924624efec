"""The roofline terms on one H100 (``repro_torch.roofline.analysis``)
and the step cost counter (``roofline.op_analysis``): each kernel's work
formula against a hand count, the meta route of every kernel wrapper
(it records that formula, returns the kernel's shapes and launches
nothing), the counter's FLOP, byte, argument and peak accounting on
small functions, and the constants against ``chip_smoke.py``'s.  All
comparisons are exact (integer counts) unless a tolerance is stated."""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch.core import frequency
from repro_torch.kernels import (dct, flash_attention, freqca_fused, meta,
                                 ops, ssd_scan)
from repro_torch.launch import steps
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import attention, blocks, common, transformer
from repro_torch.roofline import analysis, op_analysis

REPO = Path(__file__).resolve().parents[1]


def _brute_pairs(s, causal, window, t=0):
    t = t or s
    return sum((i + 1 if causal else t)
               - (max(0, i - window + 1) if window else 0)
               for i in range(s))


@pytest.mark.parametrize("s", [1, 2, 5, 64, 1000])
def test_attention_pairs_equal_the_loop(s):
    for causal in (True, False):
        for window in (0, 1, 3, 64, 4096):
            assert flash_attention.attention_pairs(s, causal, window) == \
                _brute_pairs(s, causal, window)
    assert flash_attention.attention_pairs(s, False, 0, 3 * s) == 3 * s * s


def test_kernel_work_against_hand_counts():
    fa = flash_attention
    # 4 queries causal: 1 + 2 + 3 + 4 pairs; window 2: 1 + 2 + 2 + 2
    assert fa.attention_pairs(4, True) == 10
    assert fa.attention_pairs(4, True, 2) == 7
    # 4·hd·H a pair; q, k, v, out: (2·2·4 + 2·1·4)·64 elements, 2 bytes
    assert fa.fwd_work(1, 4, 4, 2, 1, 64, "bfloat16", True) == (
        {"bfloat16": 5120}, 3072)
    assert fa.fwd_work(1, 4, 4, 2, 1, 64, "float32", True, lse=True) == (
        {"tf32": 5120}, 6144 + 32)
    # 10·hd·H a pair; q, o, dO, dQ and k, v, dK, dV, and the lse
    assert fa.bwd_work(1, 4, 4, 2, 1, 64, True) == ({"bfloat16": 12800},
                                                    6144 + 32)
    # SSD, one chunk of 2 (T = 3 pairs), one head of 1, state 1
    assert ssd_scan.scan_flops(1, 2, 1, 1, 1, 2, "bfloat16") == {
        "float32": 2 * 3 + 4 * 2, "bfloat16": 2 * 3}
    assert ssd_scan.scan_bwd_flops(1, 2, 1, 1, 1, 2) == 6 * 3 + 4 * 3 + 20
    assert ssd_scan.fwd_work(1, 2, 1, 1, 1, 2, 2) == (
        {"bfloat16": 20}, 2 * 2 * 2 + 2 * 2 * 2 + 2 * 4 + 4)
    assert ssd_scan.bwd_work(1, 2, 1, 1, 1, 2, 2)[1] == \
        (3 * 2 + 4 * 2) * 2 + 2 * 2 * 4 + 2 * 4
    # the band split: two products 2·B·m·S·D; x, high, low, the basis
    assert dct.spectral_work(1, 8, 2, 1, 4) == (
        {"tf32": 64}, 2 * 16 * 4 + 2 * 4 + 8 * 4)
    assert dct.basis_work(1, 8, 2, 4) == ({"tf32": 256}, 256 + 128)
    assert dct.basis_work(1, 8, 2, 4, with_high=True)[1] == 256 + 192
    # synthesis 2·B·S·m·D and 2·B·K·S·D; low, ring, out, basis, weights
    assert freqca_fused.spectral_work(1, 3, 8, 2, 1, 4) == (
        {"tf32": 32 + 96}, (2 + 48 + 16) * 4 + (8 + 3) * 4)
    assert freqca_fused.legacy_work(3, 16, 4, "float32") == (
        {"float32": 96}, 5 * 64 + 12)


def _meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


class _Log:
    def __init__(self):
        self.calls = []

    def __call__(self, name, flops, nbytes):
        self.calls.append((name, flops, nbytes))


def test_meta_route_records_each_kernel_and_launches_nothing():
    """Every op-layer entry on meta tensors takes the kernel route, checks
    its inputs, returns the kernel's shapes and records its formula; no
    launch count moves."""
    ops.reset_launch_counts()
    log = _Log()
    b, s, d = 2, 64, 16
    x = _meta(b, s, d, dtype=torch.float32)
    with meta.listening(log):
        q = _meta(1, 64, 4, 64, grad=True)
        k, v = (_meta(1, 64, 2, 64, grad=True) for _ in "kv")
        out = ops.flash(q, k, v, 2, causal=True)
        out.sum().backward()
        xs = _meta(1, 128, 2, 64, grad=True)
        dt = _meta(1, 128, 2, dtype=torch.float32, grad=True)
        a = _meta(2, dtype=torch.float32, grad=True)
        bm, cm = (_meta(1, 128, 16, grad=True) for _ in "bc")
        y = ops.ssd(xs, dt, a, bm, cm, 64)
        y.sum().backward()
        low, high = ops.band_split_spectral(x, 0.0625)
        m = frequency.spectral_kept_bins(s, 0.0625, "dct")
        ring = _meta(b, 3, s, d, dtype=torch.float32)
        w = _meta(b, 3, dtype=torch.float32)
        synth = frequency.low_band_basis(s, 0.0625, "dct", device="meta").T
        pred = ops.freqca_predict_spectral(low, synth, ring, w)
        tok = ops.dct_tokens(x)
        lo2, hi2 = ops.band_split(x)
        legacy = ops.freqca_predict(x, _meta(3, b, s, d, dtype=torch.float32),
                                    torch.tensor([0.9, 0.8, 0.7]),
                                    torch.tensor(0.5), 2)
    assert out.shape == q.shape and out.is_meta and q.grad.shape == q.shape
    assert y.shape == xs.shape and bm.grad.shape == bm.shape
    assert low.shape == (b, m, d) and high.shape == x.shape
    assert pred.shape == x.shape and tok.shape == x.shape
    assert lo2.shape == hi2.shape == legacy.shape == x.shape
    assert log.calls == [
        ("flash_attention", *flash_attention.fwd_work(
            1, 64, 64, 4, 2, 64, "bfloat16", True, lse=True)),
        ("flash_attention_bwd", *flash_attention.bwd_work(
            1, 64, 64, 4, 2, 64, True)),
        ("ssd_chunk_scan", *ssd_scan.fwd_work(1, 128, 2, 64, 16, 64, 2)),
        ("ssd_chunk_scan_bwd", *ssd_scan.bwd_work(1, 128, 2, 64, 16, 64,
                                                  2)),
        ("band_split_spectral", *dct.spectral_work(b, s, d, m, 4)),
        ("freqca_predict_fused_spectral", *freqca_fused.spectral_work(
            b, 3, s, d, m, 4)),
        ("token_basis_matmul", *dct.basis_work(b, s, d, 4)),
        ("token_basis_matmul", *dct.basis_work(b, s, d, 4, True)),
        ("freqca_predict_fused", *freqca_fused.legacy_work(
            3, b * s * d, 4, "float32")),
    ]
    assert not any(ops.launch_counts().values())


def test_meta_route_keeps_the_kernels_checks():
    """A shape the kernel refuses on the card is refused on meta too
    (attention at head width 256; an SSD d_state of 136)."""
    with pytest.raises(ValueError):
        ops.flash(_meta(1, 8, 2, 256), _meta(1, 8, 2, 256),
                  _meta(1, 8, 2, 256))
    with pytest.raises(ValueError):
        ssd_scan.ssd_chunk_scan(_meta(1, 64, 2, 48),
                                _meta(1, 64, 2, dtype=torch.float32),
                                _meta(2, dtype=torch.float32),
                                _meta(1, 64, 136), _meta(1, 64, 136), 64)


def test_cpu_tensors_still_take_the_plain_versions():
    x = torch.randn(1, 8, 4)
    assert not ops._on_cuda(x) and ops._on_cuda(x.to("meta"))
    log = _Log()
    with meta.listening(log):
        ops.band_split_spectral(x)
    assert log.calls == []


def test_counter_counts_products_and_bytes():
    """2·M·N·K for mm, bmm, addmm (after decomposition) and einsum; views
    and allocations free; other ops their operands and results."""
    a, b = _meta(3, 4, dtype=torch.float32), _meta(4, 5, dtype=torch.float32)
    bias = _meta(5, dtype=torch.float32)
    x3 = _meta(2, 3, 4, dtype=torch.float32)
    y3 = _meta(2, 4, 5, dtype=torch.float32)

    def fn(a, b, bias, x3, y3):
        p = a @ b                                 # mm: 120
        r = F.linear(a, b.t(), bias)              # addmm: 120
        e = torch.einsum("bij,bjk->bik", x3, y3)  # bmm: 240
        t = a.t().contiguous()                    # a copy: 48 + 48 bytes
        return p + r, e, t.view(12)
    got = op_analysis.analyze(fn, a, b, bias, x3, y3)
    assert got["by_kind"]["dense"]["flops"] == 120 + 120 + 240
    assert got["by_kind"]["dense"]["flops_by_type"] == {"float32": 480}
    assert got["flops"] == 480 and got["flops_by_type"] == {"float32": 480}
    assert got["argument_bytes"] == (12 + 20 + 5 + 24 + 40) * 4
    assert got["collectives"] == {"total_bytes": 0.0}
    assert got["by_kind"]["other"]["bytes"] >= 3 * 60 + 2 * 48


def test_counter_peak_tracks_live_storage():
    """x (4 KiB) -> y = 2x -> z = y + 1, y dropped: at most x, y and z
    live at once; the argument counted once though passed twice."""
    x = _meta(1024, dtype=torch.float32)

    def fn(x, same):
        y = x * 2
        z = y + 1
        del y
        w = z * 3                                  # y freed by now
        return w
    got = op_analysis.analyze(fn, x, x.view(32, 32))
    assert got["argument_bytes"] == 4096
    assert got["peak_bytes"] == 3 * 4096
    assert got["temp_bytes"] == 2 * 4096
    with pytest.raises(ValueError):
        op_analysis.analyze(fn, torch.ones(2), torch.ones(2))


def test_counter_rounds_blocks_as_the_allocator():
    x = _meta(3, dtype=torch.float32)             # 12 bytes: one block
    got = op_analysis.analyze(lambda x: x + 1, x)
    assert got["argument_bytes"] == 12
    assert got["peak_bytes"] == 2 * 512


def test_a_reduced_prefill_counts_its_flash_launches():
    """yi-9b reduced, one sequence of 2048 tokens (the blockwise
    threshold): every layer's attention is one kernel record of the
    forward's formula, and the dense products are the model's."""
    cfg = dataclasses.replace(configs.reduced(configs.get_config("yi-9b")),
                              head_dim=64, n_heads=2, n_kv_heads=1)
    specs = transformer.lm_specs(cfg)
    params = common.abstract_params(specs, torch.float32)
    tokens = _meta(1, 2048, dtype=torch.int32)
    step = steps.make_prefill_step(cfg)
    got = op_analysis.analyze(step, params, {"tokens": tokens})
    flash = got["by_kind"]["flash_attention"]
    assert flash["calls"] == cfg.n_layers
    work, nb = flash_attention.fwd_work(1, 2048, 2048, 2, 1, 64, "float32",
                                        True)
    assert flash["flops"] == cfg.n_layers * work["tf32"]
    assert flash["bytes"] == cfg.n_layers * nb
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    per_layer = 2 * 2048 * (d * 2 * hd + 2 * d * hd + 2 * hd * d
                            + 3 * d * f)
    head = 2 * d * cfg.vocab_size              # the last token only
    assert got["by_kind"]["dense"]["flops"] == cfg.n_layers * per_layer \
        + head


def test_decode_step_work_counts():
    """``decode_step_bytes`` / ``decode_step_flops`` on a reduced yi-9b
    cache at position 3: every weight once (the untied table's batch
    rows), the K and V buffers read and one slot of each written, the
    logits; 2 a weight and token, 4·hd a head and valid slot."""
    cfg = configs.reduced(configs.get_config("yi-9b"))
    params = common.init_params(transformer.lm_specs(cfg), 0,
                                torch.float32, "cpu")
    batch, slots = 2, 8
    cache = blocks.stack_cache_zeros(cfg, batch, slots, torch.float32, "cpu")
    for g in cache:
        g["l0"].index = 3
    leaves = [p for p in common_leaves(params)]
    n_w = sum(p.numel() for p in leaves)
    emb = cfg.vocab_size * cfg.d_model
    kv = batch * slots * cfg.n_kv_heads * cfg.head_dim
    want_bytes = 4 * (n_w - (cfg.vocab_size - batch) * cfg.d_model
                      + cfg.n_layers * (2 * kv + 2 * kv // slots)
                      + batch * cfg.vocab_size)
    assert op_analysis.decode_step_bytes(cfg, params, cache, batch) == \
        want_bytes
    n_mat = sum(p.numel() for p in leaves if p.dim() == 2) - emb
    want = 2.0 * n_mat * batch + cfg.n_layers * 4.0 * cfg.head_dim \
        * cfg.n_heads * 4 * batch
    assert op_analysis.decode_step_flops(cfg, params, cache, batch) == want


def common_leaves(tree):
    from repro_torch.optim import adamw
    return adamw.leaves(tree)


def test_roofline_terms_and_constants():
    """The H100's published peaks, the same as chip_smoke's bounds; the
    terms of a step, by operand type; no collective term given None."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    assert analysis.PEAK_FLOPS == chip_smoke.PEAK_FLOPS
    assert analysis.HBM_BW == chip_smoke.HBM_BYTES_PER_S
    assert (analysis.HBM_BYTES, analysis.LINK_BW) == (80e9, 450e9)
    t = analysis.roofline_terms({"bfloat16": 989e12, "tf32": 495e12},
                                3.35e12, None, 1)
    assert t["compute_s"] == pytest.approx(2.0, rel=1e-12)
    assert t["memory_s"] == pytest.approx(1.0, rel=1e-12)
    assert t["collective_s"] is None and t["bottleneck"] == "compute_s"
    t = analysis.roofline_terms(989e12, 3.35e12 * 4, 450e9 * 8, 2)
    assert t["bottleneck"] == "collective_s" and t["collective_s"] == 4.0
    assert analysis.model_flops(10, 3, True) == 180.0
    assert analysis.model_flops(10, 3, False) == 60.0


def test_memory_dict_and_collectives():
    counted = {"argument_bytes": 10, "temp_bytes": 5, "peak_bytes": 15}
    assert analysis.memory_dict(counted) == {
        "argument_size_bytes": 10, "temp_size_bytes": 5, "peak_bytes": 15}
    assert analysis.collectives({"total_bytes": 0.0}, 1) == {
        "total_bytes": 0.0}
    many = analysis.collectives({"total_bytes": 0.0}, 256)
    assert many["total_bytes"] is None and "no collective term" in \
        many["note"]


def test_models_route_meta_as_the_card():
    """self-attention from 2048 tokens and the band split of a [B, S, D]
    CRF take the kernels on meta, as on the card."""
    cfg = dataclasses.replace(configs.reduced(configs.get_config("yi-9b")),
                              head_dim=64, n_heads=2, n_kv_heads=1)
    p = common.abstract_params(attention.attn_specs(cfg), torch.float32)
    log = _Log()
    with meta.listening(log):
        attention.self_attention(p, _meta(1, 2048, cfg.d_model,
                                          dtype=torch.float32), cfg)
        frequency.decompose(_meta(2, 64, 8, dtype=torch.float32), 0.25,
                            "dct")
    assert [c[0] for c in log.calls] == ["flash_attention",
                                        "token_basis_matmul"]
    assert mesh_lib.one_card_mesh().size == 1

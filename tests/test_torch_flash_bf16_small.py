"""The bf16 small-width flash kernels' arithmetic, on the CPU.

``csrc/flash_bf16_small.cuh`` runs attention in bf16 at head widths up to
32 on the bf16 tensor cores.  The card's tests hold the kernels against
the plain versions (``tests/test_torch_cuda.py``); here:

- ``online_bf16_attention`` repeats the forward's rounding in PyTorch:
  key tiles of 64, a running max in base 2 that moves only where a
  tile's max passes it by more than 8 (the kernel's lazy rescaling), the
  unnormalised P rounded to bf16 once per tile before P·V, the
  normaliser summed from the unrounded P.  It stays within the bf16
  tolerance (2e-2 of the largest output) of ``ref.attention_ref`` and of
  the reference's Pallas kernel in interpret mode, and its log-sum-exp
  within 1e-5 of ``ref.attention_lse_ref``'s, at head widths 16 and 32
  in causal GQA and with a window of 24.
- On ``meta`` tensors the wrappers record the bf16 small forms' work
  under ``bfloat16`` (the bf16 tensor cores' peak), not ``tf32``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import meta, ops, ref

BF = torch.bfloat16
TOL = 2e-2
TILE = 64          # the forward's key tile (kFwdBK)
LAZY = 8.0         # the lazy rescaling's lag, log2 units (kLazy)
MASKED = -2.0 ** 100   # flash::kMaskedLogit


def online_bf16_attention(q, k, v, q_per_kv=1, causal=False, window=0):
    """The bf16 small-width forward's arithmetic in PyTorch: ``(out, lse)``
    for q [B, S, Hq, hd], k, v [B, T, Hkv, hd] in bf16; float32 logits
    from the bf16 inputs, P rounded to bf16 per key tile."""
    b, s, hq, hd = q.shape
    t = k.shape[1]
    kk = k.float().repeat_interleave(q_per_kv, dim=2)
    vv = v.float().repeat_interleave(q_per_kv, dim=2)
    sl2 = (1.0 / math.sqrt(hd)) * (1.0 / math.log(2.0))
    keep = ref.attention_mask(s, t, causal, window)
    m = torch.full((b, hq, s, 1), MASKED)
    norm = torch.zeros((b, hq, s, 1))
    acc = torch.zeros((b, hq, s, hd))
    for k0 in range(0, t, TILE):
        sc = torch.einsum("bshd,bthd->bhst", q.float(), kk[:, k0:k0 + TILE])
        if keep is not None:
            sc = torch.where(keep[:, None, :, k0:k0 + TILE], sc, MASKED)
        mx = sc.amax(-1, keepdim=True) * sl2
        m_new = torch.where(mx > m + LAZY, mx, m)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(sc * sl2 - m_new)
        norm = norm * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum(
            "bhst,bthd->bhsd", p.to(BF).float(), vv[:, k0:k0 + TILE])
        m = m_new
    norm = norm.clamp_min(1e-30)
    out = (acc / norm).permute(0, 2, 1, 3).to(BF)
    lse = ((m + torch.log2(norm)) * math.log(2.0)).squeeze(-1)
    return out, lse


def _inputs(b, s, hq, hkv, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
            for _ in "kv")
    return tuple(torch.from_numpy(x).to(BF) for x in (q, k, v))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# the reference's compile options for its one program a case (level 0:
# the same HLO, XLA's CPU compile ~3x faster)
_FAST = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24)])
def test_online_bf16_rounding_matches_plain_and_pallas(hd, causal, window):
    """The kernel's rounding (P in bf16 per key tile of 64, lazily
    rescaled) against the plain version and the Pallas kernel in
    interpret mode (blocks of 32), causal GQA 4/2 at S 128 (two key
    tiles)."""
    q, k, v = _inputs(1, 128, 4, 2, hd, seed=60 + hd + window)
    out, lse = online_bf16_attention(q, k, v, 2, causal, window)
    want, want_lse = ref.attention_lse_ref(q, k, v, 2, causal, window)
    assert _rel(out.float(), want.float()) <= TOL
    assert float((lse - want_lse).abs().max()) <= 1e-5 * float(
        want_lse.abs().max())
    args = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
            for x in (q, k, v)]
    pallas = jax.jit(lambda a, c, e: jfa.flash_attention(
        a, c, e, 2, causal=causal, window=window, q_block=32, kv_block=32,
        interpret=True)).lower(*args).compile(_FAST)(*args)
    assert _rel(out.float(), np.asarray(pallas, np.float32)) <= TOL


def test_online_bf16_rescales_lazily():
    """A key tile whose logits pass the running max by less than 2^8 in p
    leaves the max where it was (P above 1, up to 2^8) and changes
    nothing past the rounding: the output against the plain version."""
    q, k, v = _inputs(1, 256, 2, 2, 32, seed=70)
    k = k.clone()
    k[:, 64:128] = (k[:, 64:128].float() * 1.5).to(BF)   # larger logits
    out, _ = online_bf16_attention(q, k, v)
    assert _rel(out.float(), ref.attention_ref(q, k, v).float()) <= TOL


class _Log(list):
    def __call__(self, name, flops, nbytes):
        self.append((name, flops, nbytes))


@pytest.mark.parametrize("hd", [16, 24, 32])
def test_meta_records_the_bf16_small_forms_under_bfloat16(hd):
    """The bf16 small widths' forward and backward record their work
    under ``bfloat16`` (4·hd and 10·hd FLOP a kept pair and head) and
    launch nothing."""
    b, s, hq, hkv = 2, 96, 4, 2

    def t(*shape, dtype=BF):
        return torch.empty(shape, dtype=dtype, device="meta")
    q, do, k = t(b, s, hq, hd), t(b, s, hq, hd), t(b, s, hkv, hd)
    lse = t(b, hq, s, dtype=torch.float32)
    log = _Log()
    ops.reset_launch_counts()
    with meta.listening(log):
        out, _ = fa.flash_attention(q, k, k, 2, True, 24, return_lse=True)
        fa.flash_attention_bwd(q, k, k, out, lse, do, 2, True, 24)
    pairs = b * hq * fa.attention_pairs(s, True, 24)
    assert [(n, f) for n, f, _ in log] == [
        ("flash_attention_f32", {"bfloat16": 4 * hd * pairs}),
        ("flash_attention_f32_bwd", {"bfloat16": 10 * hd * pairs})]
    assert not any(ops.launch_counts().values())

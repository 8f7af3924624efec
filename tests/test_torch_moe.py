"""Port parity: the mixture-of-experts FFN (``models.moe``: ``_route``,
``moe_ffn`` with the GShard einsum dispatch, ``moe_ffn_gather`` with
slot gathers) and the five configs this slice registers, against
``repro`` on the CPU in float32, on parameters carried across by
``bridge.lm_params_from_jax_numpy``.

Routing is discontinuous, so every comparison of routing first asserts
that each token's gap between its k-th and (k+1)-th router probability
(over the real experts) is at least ROUTE_MARGIN = 1e-5; the two
packages' probabilities differ by at most 1e-6 here (asserted on every
call below, measured ~1e-7), so no selection can flip.  A draw that
fails the margin fails the test.  After it, the routing masks, the
ranks and the number of dropped slots must match exactly (the
``drop_fraction`` values to one float32 ulp: compiled, the reference
multiplies by the reciprocal of the slot count).

Tolerances: the FFN's output 1e-5 of its largest magnitude (float32
sums in other orders); the load-balance and z-losses 1e-6 relative;
einsum against gather in the port 1e-6 of the largest output (the same
products, combined in other orders).

The reference's gather form returns NaN wherever a slot it drops
gathers past the ``[e·cap]`` table (``take_along_axis``'s default
``fill`` mode): with drops it is compared where it is finite, the NaN
rows are shown to be exactly those, and the port's gather form is held
to the reference's einsum form everywhere.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.sharding import partitioning as jpart
import repro_torch.configs as tconfigs
from repro_torch.launch import steps as tsteps
from repro_torch.models import blocks as tblocks
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from test_torch_lm import _reference_init

ROUTE_MARGIN = 1e-5     # k-th minus (k+1)-th router probability
PROB_TOL = 1e-6         # the packages' router probabilities, absolute
OUT_TOL = 1e-5
AUX_TOL = 1e-6

NEW_ARCHS = ["granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b",
             "deepseek-coder-33b", "llama3-405b", "command-r-plus-104b"]
MOE_ARCHS = NEW_ARCHS[:2]


def route_gaps(probs, top_k: int, n_real: int) -> torch.Tensor:
    """Each token's k-th minus (k+1)-th probability over the real
    experts (``probs [..., E]``)."""
    top = torch.topk(probs[..., :n_real], top_k + 1, dim=-1).values
    return top[..., top_k - 1] - top[..., top_k]


def assert_margins(records, margin: float = ROUTE_MARGIN) -> int:
    """Every routing recorded by ``route_spy`` clears ``margin``;
    returns the number of tokens routed."""
    assert records, "no MoE layer routed"
    n = 0
    for probs, top_k, n_real in records:
        gaps = route_gaps(probs, top_k, n_real)
        assert float(gaps.min()) >= margin, float(gaps.min())
        n += gaps.numel()
    return n


@pytest.fixture
def route_spy(monkeypatch):
    """Records (probs, top_k, n_real) of every ``moe._route`` call."""
    records = []
    real = tmoe._route

    def spy(logits, top_k, n_real=0):
        out = real(logits, top_k, n_real)
        records.append((out[2].detach().clone(), top_k,
                        n_real or logits.shape[-1]))
        return out
    monkeypatch.setattr(tmoe, "_route", spy)
    return records


# the reference's two forms, compiled once per shape (eager dispatch
# compiles every op)
_JFFN = {impl: jax.jit(fn, static_argnames=("cfg", "group_size"))
         for impl, fn in (("einsum", jmoe.moe_ffn),
                          ("gather", jmoe.moe_ffn_gather))}
_TFFN = {"einsum": tmoe.moe_ffn, "gather": tmoe.moe_ffn_gather}


def _moe_configs(arch, **moe_over):
    cj = jconfigs.reduced(jconfigs.get_config(arch))
    ct = tconfigs.reduced(tconfigs.get_config(arch))
    if moe_over:
        cj = dataclasses.replace(cj, moe=dataclasses.replace(cj.moe,
                                                             **moe_over))
        ct = dataclasses.replace(ct, moe=dataclasses.replace(ct.moe,
                                                             **moe_over))
    return cj, ct


def _ffn_params(cj, seed=0):
    """One MoE layer's parameters: the reference's (numpy-drawn with
    its init rules, as a one-layer stack) and the port's copy."""
    specs = jcommon.stack_specs(jmoe.moe_specs(cj), 1)
    pj = jax.tree.map(lambda a: a[0], _reference_init(specs, seed))
    pt = {k: torch.tensor(np.asarray(v)) for k, v in pj.items()}
    return pj, pt


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _reference_routing(pj, x, cj, group):
    """The reference's router logits, routing and ranks, per group,
    from its own ``_route`` (no vmap)."""
    xt = jnp.asarray(x).reshape(-1, group, x.shape[-1])
    logits = jnp.einsum("ngd,de->nge", xt, pj["router"])
    route = jax.jit(jmoe._route, static_argnums=(1, 2))
    out = [route(lg, cj.moe.top_k, cj.moe.n_experts) for lg in logits]
    weights, mask, probs = (np.stack([np.asarray(o[i]) for o in out])
                            for i in range(3))
    pos = np.cumsum(mask, axis=1) * mask - 1.0
    return weights, mask, probs, pos


def _port_routing(pt, x, ct, group):
    xt = torch.tensor(x).reshape(-1, group, x.shape[-1])
    _, weights, mask, probs, pos = tmoe._routing(pt, xt, ct)
    return weights, mask, probs, pos


def _check_routing(pj, pt, x, cj, ct, group):
    """Margins first, then the masks and ranks exactly and the
    probabilities and weights to PROB_TOL."""
    wt, mt, pt_, post = _port_routing(pt, x, ct, group)
    wj, mj, pj_, posj = _reference_routing(pj, x, cj, group)
    assert np.abs(pt_.numpy() - pj_).max() <= PROB_TOL
    assert float(route_gaps(pt_, ct.moe.top_k, ct.moe.n_experts).min()) >= \
        ROUTE_MARGIN
    np.testing.assert_array_equal(mt.numpy(), mj)
    np.testing.assert_array_equal(post.numpy(), posj)
    assert np.abs(wt.numpy() - wj).max() <= PROB_TOL
    return post.numpy()


def drop_count(df, n_slots: int) -> int:
    """The dropped (token, k) slots a ``drop_fraction`` stands for."""
    return round(float(df) * n_slots)


def assert_same_drops(df_port, df_ref, n_slots: int):
    """The same number of dropped slots, and the fractions within one
    float32 ulp of 1 (compiled, the reference divides by the slot count
    as a product with its reciprocal: −3e-8 where nothing drops; eager,
    bitwise the port's)."""
    assert df_port.dtype == torch.float32
    assert drop_count(df_port, n_slots) == drop_count(df_ref, n_slots)
    assert abs(float(df_port) - float(df_ref)) <= 2.0 ** -23


def _check_aux(at, aj, n_slots):
    for name in ("load_balance_loss", "router_z_loss"):
        got, want = float(getattr(at, name)), float(getattr(aj, name))
        assert abs(got - want) <= AUX_TOL * abs(want), name
    assert_same_drops(at.drop_fraction, aj.drop_fraction, n_slots)


def _close(got, want, tol=OUT_TOL):
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().numpy() - want).max() / np.abs(want).max()
    assert err <= tol, err


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_configs_match_reference(arch):
    """Field for field, full and reduced, with the derived properties,
    and registered."""
    assert tconfigs.get_config(arch) is tconfigs.REGISTRY[arch]
    for cj, ct in ((jconfigs.get_config(arch), tconfigs.get_config(arch)),
                   (jconfigs.reduced(jconfigs.get_config(arch)),
                    tconfigs.reduced(tconfigs.get_config(arch)))):
        assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
        assert ct.q_per_kv == cj.q_per_kv
        assert ct.layer_kinds() == cj.layer_kinds()
        assert [ct.is_moe_layer(i) for i in range(ct.n_layers)] == \
            [cj.is_moe_layer(i) for i in range(cj.n_layers)]
        if cj.moe is not None:
            assert ct.moe.e_total == cj.moe.e_total


def test_e_total_counts_padded_experts():
    for n, pad in ((40, 0), (40, 48), (16, 8)):
        assert tconfigs.base.MoEConfig(n_experts=n, padded_experts=pad) \
            .e_total == jconfigs.MoEConfig(n_experts=n,
                                           padded_experts=pad).e_total


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_param_bytes_matches_reference(arch, reduced):
    cj, ct = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if reduced:
        cj, ct = jconfigs.reduced(cj), tconfigs.reduced(ct)
    for per in (2, 4):
        assert tsteps.param_bytes(ct, per) == jpart.param_bytes(cj, per)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_leaves_draw_with_the_reference_rule(arch):
    """The reference's fan-in rule reads dim 0 of its stacked 4-D expert
    leaves ``[n_layers, e, d, f]``: std 1/sqrt(n_layers); the router
    keeps its 0.02.  The specs say so at full size, and both packages'
    draws at reduced size (2 layers: 1/sqrt(2)) have that std within
    3%."""
    full = tconfigs.get_config(arch)
    ffn = ttransformer.lm_specs(full)["stack"][0]["l0"]["ffn"]
    assert ffn["router"].std() == 0.02
    for name in ("wi_gate", "wi_up", "wo"):
        assert ffn[name].ref_shape[0] == full.n_layers
        assert ffn[name].std() == 1.0 / math.sqrt(full.n_layers)
    cj, ct = _moe_configs(arch)
    pj = jcommon.init_params(jtransformer.lm_specs(cj), jax.random.key(0))
    pt = tcommon.init_params(ttransformer.lm_specs(ct), seed=0,
                             device="cpu")
    for name, want in (("router", 0.02), ("wi_gate", 2 ** -0.5),
                       ("wi_up", 2 ** -0.5), ("wo", 2 ** -0.5)):
        ref_std = float(np.asarray(pj["stack"]["l0"]["ffn"][name]).std())
        port = torch.stack([g["l0"]["ffn"][name] for g in pt["stack"]])
        assert tuple(port.shape) == pj["stack"]["l0"]["ffn"][name].shape
        for got in (ref_std, float(port.std())):
            assert abs(got - want) <= 0.03 * want, (name, got)


def test_layer_plan_places_moe_in_a_hybrid_group():
    """``every=2`` inside a hybrid group of 8: the MoE FFN on the odd
    positions, the attention layer last, as the reference's plan."""
    from repro.models import blocks as jblocks
    kw = dict(arch_id="tiny", family="hybrid", n_layers=16, d_model=64,
              n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=256, head_dim=16,
              attn_every=8)
    cj = jconfigs.ModelConfig(**kw, moe=jconfigs.MoEConfig(
        n_experts=4, top_k=2, every=2))
    ct = tconfigs.ModelConfig(**kw, moe=tconfigs.base.MoEConfig(
        n_experts=4, top_k=2, every=2))
    plan = tblocks._layer_plan(ct)
    assert plan == jblocks._layer_plan(cj)
    assert plan[2] == tuple(("attn" if i == 7 else "ssm", i % 2 == 1)
                            for i in range(8))
    specs = tblocks.stack_specs(ct)[1]
    assert sorted(specs["l1"]["ffn"]) == ["router", "wi_gate", "wi_up", "wo"]
    assert sorted(specs["l0"]["ffn"]) == ["wi_gate", "wi_up", "wo"]


# ---------------------------------------------------------------------------
# the FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf", [16.0, 0.5])
@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_moe_ffn_matches_reference(arch, cf, impl):
    """Two groups of 48 tokens: with cf 16 nothing drops; with cf 0.5
    half the (token, expert) pairs do."""
    cj, ct = _moe_configs(arch, capacity_factor=cf)
    pj, pt = _ffn_params(cj, seed=1)
    x = _x(2, 48, ct.d_model, seed=2)
    pos = _check_routing(pj, pt, x, cj, ct, 48)
    yj, aj = _JFFN[impl](pj, jnp.asarray(x), cfg=cj, group_size=48)
    yt, at = _TFFN[impl](pt, torch.tensor(x), ct, group_size=48)
    _check_aux(at, aj, x.shape[0] * x.shape[1] * ct.moe.top_k)
    assert (float(at.drop_fraction) == 0.0) == (cf == 16.0)
    yj = np.asarray(yj).reshape(-1, ct.d_model)
    yt = yt.reshape(-1, ct.d_model)
    bad = ~np.isfinite(yj).all(axis=-1)
    if impl == "gather":
        # the reference's NaN rows: a routed pair not kept whose index
        # top_idx·cap + pos runs past the e·cap table
        _, _, cap = tmoe._capacity(ct, x.shape[0] * x.shape[1], 48)
        e = ct.moe.e_total
        pos = pos.reshape(-1, e)
        past = ((pos >= cap) & (np.arange(e) * cap + pos >= e * cap)).any(-1)
        np.testing.assert_array_equal(bad, past)
        _close(yt, np.asarray(_JFFN["einsum"](pj, jnp.asarray(x), cfg=cj,
                                              group_size=48)[0]).reshape(
            yt.shape))
    else:
        assert not bad.any()
    assert (bad.any()) == (impl == "gather" and cf == 0.5)
    _close(yt[~torch.tensor(bad)], yj[~bad])


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_padded_experts_match_reference_and_are_never_routed(impl):
    """``padded_experts=6`` over 4 real ones: the router has 6 columns;
    the two padded ones get probability 0, no token, and count in the
    z-loss only (the reference's logsumexp runs over every column)."""
    cj, ct = _moe_configs("phi3.5-moe-42b-a6.6b", padded_experts=6)
    assert ct.moe.e_total == 6
    pj, pt = _ffn_params(cj, seed=3)
    assert tuple(pt["router"].shape) == (ct.d_model, 6)
    x = _x(1, 64, ct.d_model, seed=4)
    _check_routing(pj, pt, x, cj, ct, 64)
    _, mask, probs, _ = _port_routing(pt, x, ct, 64)
    assert float(probs[..., 4:].abs().max()) == 0.0
    assert float(mask[..., 4:].abs().max()) == 0.0
    yj, aj = _JFFN[impl](pj, jnp.asarray(x), cfg=cj)
    yt, at = _TFFN[impl](pt, torch.tensor(x), ct)
    _check_aux(at, aj, 64 * ct.moe.top_k)
    _close(yt, yj)


@pytest.mark.parametrize("cf", [16.0, 1.0, 0.5])
def test_einsum_and_gather_agree_in_the_port(cf):
    """Same routing, same capacity drops: the outputs to 1e-6 of their
    largest, the aux terms bitwise (the same routing tensors).  At cf 1
    an expert holds exactly its mean load, so an unbalanced router
    drops."""
    _, ct = _moe_configs("granite-moe-3b-a800m", capacity_factor=cf)
    cj, _ = _moe_configs("granite-moe-3b-a800m", capacity_factor=cf)
    _, pt = _ffn_params(cj, seed=5)
    x = torch.tensor(_x(4, 32, ct.d_model, seed=6))
    ye, ae = tmoe.moe_ffn(pt, x, ct, group_size=64)
    yg, ag = tmoe.moe_ffn_gather(pt, x, ct, group_size=64)
    err = float((ye - yg).abs().max() / ye.abs().max())
    assert err <= 1e-6, err
    for a, b in zip(ae, ag, strict=True):
        assert torch.equal(a, b)
    assert (float(ae.drop_fraction) > 0) == (cf < 16)


def test_gradients_of_both_dispatches_match_reference():
    """The FFN's output and aux terms under autograd: the gradients of a
    loss through either form (x, the router and the experts) match the
    reference's einsum form's (1e-5 relative L2; with cf 1.25 some
    pairs drop)."""
    cj, ct = _moe_configs("granite-moe-3b-a800m")
    pj, pt = _ffn_params(cj, seed=7)
    x = _x(2, 32, ct.d_model, seed=8)
    w = _x(2, 32, ct.d_model, seed=9)

    def jloss(p, xx):
        y, a = jmoe.moe_ffn(p, xx, cj)
        return (jnp.sum(y * w) + a.load_balance_loss
                + 0.1 * a.router_z_loss)
    gp, gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(pj, jnp.asarray(x))
    for ft in (tmoe.moe_ffn, tmoe.moe_ffn_gather):
        leaves = {k: v.clone().requires_grad_() for k, v in pt.items()}
        xx = torch.tensor(x).requires_grad_()
        y, a = ft(leaves, xx, ct)
        (torch.sum(y * torch.tensor(w)) + a.load_balance_loss
         + 0.1 * a.router_z_loss).backward()
        for got, want in [(xx.grad, gx)] + [(leaves[k].grad, gp[k])
                                            for k in leaves]:
            want = np.asarray(want)
            rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
            assert rel <= 1e-5, (ft.__name__, rel)


def test_decode_shape_routes_the_batch_as_one_group():
    """A decode step's ``[B, 1, d]``: one group of B tokens, capacity
    max(ceil(B·k·cf / E), k), as the reference's."""
    cj, ct = _moe_configs("granite-moe-3b-a800m")
    pj, pt = _ffn_params(cj, seed=10)
    x = _x(3, 1, ct.d_model, seed=11)
    assert tmoe._capacity(ct, 3, 2048) == (3, 1, 2)
    _check_routing(pj, pt, x, cj, ct, 3)
    for impl in ("einsum", "gather"):
        yj, aj = _JFFN[impl](pj, jnp.asarray(x), cfg=cj)
        yt, at = _TFFN[impl](pt, torch.tensor(x), ct)
        _check_aux(at, aj, 3 * ct.moe.top_k)
        _close(yt, yj)


def test_tokens_not_divisible_by_the_group_raise():
    _, ct = _moe_configs("granite-moe-3b-a800m")
    pt = tcommon.init_params(tmoe.moe_specs(ct), seed=0, device="cpu")
    for fn in (tmoe.moe_ffn, tmoe.moe_ffn_gather):
        with pytest.raises(ValueError, match="not divisible"):
            fn(pt, torch.zeros(1, 50, ct.d_model), ct, group_size=32)


def test_route_spy_sees_every_moe_layer(route_spy):
    """The margin helper's spy: one record per MoE layer of a forward."""
    _, ct = _moe_configs("granite-moe-3b-a800m")
    params = tcommon.init_params(ttransformer.lm_specs(ct), seed=0,
                                 device="cpu")
    ttransformer.forward(params, torch.zeros(1, 16, dtype=torch.int64), ct)
    assert len(route_spy) == ct.n_layers
    assert route_spy[0][0].shape == (1, 16, ct.moe.e_total)

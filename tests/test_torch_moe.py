"""The port's MoE MLP against the JAX reference's ``layers.moe_mlp`` (CPU).

Parameters come from JAX ``init_moe`` and inputs from a numpy seed, passed
through numpy to both frameworks. Tolerances: f32 relative max error 1e-4;
bf16 2e-2 (tests/test_kernels.py's bf16 limit: both round the expert
products and the combine to bf16, each in its own order). The routing is
held exactly: the same experts, queue places and dropped assignments,
ties going to the lower expert index as ``jax.lax.top_k`` sends them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.deepseek_config import DeepSeekMoEConfig

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, S = 2, 16


def configs(**kw):
    """(JAX config, port config): reduced mixtral-8x7b (4 experts, top 2,
    d_model 64, d_ff 128, drop-free capacity factor 8.0), ``kw`` replaced."""
    return (dataclasses.replace(jax_reduced(jax_get_config("mixtral_8x7b")), **kw),
            dataclasses.replace(reduced(get_config("mixtral_8x7b")), **kw))


def make(jcfg, tcfg, seed=0, router=None):
    """JAX and port MoE params and inputs (B, S, d) in the config's dtype;
    ``router`` (numpy (d, E)) replaces the drawn router."""
    jp, _ = JL.init_moe(jax.random.PRNGKey(seed), jcfg)
    tree = {k: np.asarray(v) for k, v in jp.items()}
    if router is not None:
        tree["router"] = router.astype(np.float32)
        jp = {k: jnp.asarray(v) for k, v in tree.items()}
    x = np.random.default_rng(seed + 10).standard_normal((B, S, jcfg.d_model), dtype=np.float32)
    jx = jnp.asarray(x, dtype=jcfg.dtype)
    dt = L.DTYPES[tcfg.dtype]
    tp = {k: torch.tensor(np.asarray(v, np.float32)).to(torch.float32 if k == "router" else dt)
          for k, v in jp.items()}
    tx = torch.from_numpy(x).to(dt)
    return jp, jx, tp, tx


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def jax_route(jp, jx, jcfg):
    """The reference's chosen experts and kept flags (G, g, k), recomputed
    from its own formulas (``layers.moe_mlp`` returns only the output)."""
    E, k = jcfg.moe.n_experts, jcfg.moe.top_k
    g = min(jcfg.moe_group, jx.shape[1])
    xg = jx.reshape(-1, g, jx.shape[-1])
    cap = max(1, int(k * g * jcfg.moe_capacity_factor / E))
    _, chosen = jax.lax.top_k(xg.astype(jnp.float32) @ jp["router"], k)
    onehot = jax.nn.one_hot(chosen, E, dtype=jnp.float32)
    flat = onehot.reshape(onehot.shape[0], g * k, E)
    pos = jnp.einsum("gske,gske->gsk", (jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape),
                     onehot)
    return np.asarray(chosen), np.asarray(pos < cap)


def check(jcfg, tcfg, tol=1e-4, **kw):
    jp, jx, tp, tx = make(jcfg, tcfg, **kw)
    want = np.asarray(JL.moe_mlp(jp, jx, jcfg).astype(jnp.float32))
    got = L.moe_mlp(tp, tx, tcfg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    err = rel_err(got.float().numpy(), want)
    assert err <= tol, err
    route = L.moe_route(tp["router"], tx, tcfg)
    chosen, kept = jax_route(jp, jx, jcfg)
    np.testing.assert_array_equal(route.expert.numpy(), chosen)
    np.testing.assert_array_equal(route.keep.numpy(), kept)
    return route, got


@pytest.mark.parametrize("activation", ["swiglu", "squared_relu"])
@pytest.mark.parametrize("capacity_factor,group,drops", [
    (8.0, 2048, False),   # the reduced configs' drop-free capacity
    (1.0, 2048, True),    # g = 16, cap = 8: some queues overflow
    (1.25, 4, True),      # four groups per sequence, the published capacity factor
])
def test_moe_matches_jax(activation, capacity_factor, group, drops):
    jcfg, tcfg = configs(activation=activation, moe_capacity_factor=capacity_factor,
                         moe_group=group)
    route, _ = check(jcfg, tcfg)
    assert bool((~route.keep).any()) == drops
    if drops:  # a dropped assignment has weight 0; the kept ones keep theirs
        assert bool((route.weights[~route.keep] == 0).all())
        assert bool((route.weights[route.keep] > 0).all())
    G = B * (S // min(group, S))
    assert route.expert.shape == (G, S * B // G, 2)


@pytest.mark.parametrize("tie", ["all_equal", "two_columns_equal"])
def test_moe_ties_choose_the_reference_experts(tie):
    """Equal router logits: ``jax.lax.top_k`` takes the lower expert index
    first; a plain ``torch.topk`` promises no order."""
    jcfg, tcfg = configs(moe_capacity_factor=1.0)
    d, E = jcfg.d_model, jcfg.moe.n_experts
    if tie == "all_equal":
        router = np.zeros((d, E), np.float32)
    else:
        router = np.random.default_rng(3).standard_normal((d, E), dtype=np.float32)
        router[:, 3] = router[:, 1]
    route, _ = check(jcfg, tcfg, router=router)
    if tie == "all_equal":  # every token picks experts 0 then 1; queues overflow
        assert bool((route.expert == torch.tensor([0, 1])).all())
        assert bool((~route.keep).any())
    else:  # expert 3 only ever second, behind its twin 1
        both = (route.expert == 3).any(dim=-1)
        assert bool(both.any())
        assert bool((route.expert[both] == torch.tensor([1, 3])).all())


def test_moe_bf16_matches_jax():
    jcfg, tcfg = configs(dtype="bfloat16", moe_capacity_factor=1.0)
    route, got = check(jcfg, tcfg, tol=2e-2)
    assert got.dtype == torch.bfloat16 and bool((~route.keep).any())


def test_moe_is_bitwise_repeatable():
    jcfg, tcfg = configs(moe_capacity_factor=1.0)
    _, _, tp, tx = make(jcfg, tcfg, seed=4)
    assert torch.equal(L.moe_mlp(tp, tx, tcfg), L.moe_mlp(tp, tx, tcfg))


def test_moe_group_must_divide_the_sequence():
    _, tcfg = configs(moe_group=6)
    p = L.init_moe(torch.Generator().manual_seed(0), tcfg)
    with pytest.raises(ValueError, match="multiple of the group"):
        L.moe_mlp(p, torch.zeros((B, S, tcfg.d_model)), tcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_takes_moe_stacks(dtype):
    jcfg, tcfg = configs(dtype=dtype)
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg)
    p = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    R, d, f, E = tcfg.n_repeats, tcfg.d_model, tcfg.d_ff, tcfg.moe.n_experts
    moe = p["blocks"][0]["mlp"]
    want = {"router": ((R, d, E), torch.float32),
            "w_gate": ((R, E, d, f), L.DTYPES[dtype]), "w_up": ((R, E, d, f), L.DTYPES[dtype]),
            "w_down": ((R, E, f, d), L.DTYPES[dtype])}
    assert {k: (tuple(v.shape), v.dtype) for k, v in moe.items()} == want
    np.testing.assert_array_equal(moe["w_down"].float().numpy(),
                                  np.asarray(jparams["blocks"][0]["mlp"]["w_down"], np.float32))
    # the port's own init draws the same leaves
    mine = L.init_moe(torch.Generator().manual_seed(0), tcfg)
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == {
        k: (s[1:], dt) for k, (s, dt) in want.items()}


def _moe_local_by_indexing(p, x, cfg, first=0):
    """``layers._moe_local`` as it gathered before the dispatch and combine
    became ops: the tokens with one zero row appended, indexed by an int map
    whose empty rows point at it; the outputs indexed back with dropped
    assignments at row 0; a loop over the slots (one sum for k > 2). Kept
    here as the bits the CPU route must still give."""
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    E_l = p["w_gate"].shape[0]
    B, S, d = x.shape
    if isinstance(cfg.moe, DeepSeekMoEConfig):
        r = L.moe_route_grouped(p["router"], p["e_bias"], x, cfg)
    else:
        r = L.moe_route(p["router"], x, cfg)
    G, g, _ = r.expert.shape
    rows = G * r.cap
    group = torch.arange(G).reshape(G, 1, 1)
    expert, keep, weights = r.expert, r.keep, r.weights
    if E_l < E:
        mine = (expert >= first) & (expert < first + E_l)
        expert, keep, weights = expert - first, keep & mine, weights * mine
    dest = (expert * rows + group * r.cap + r.slot).reshape(-1)
    keep = keep.reshape(-1)
    token = torch.arange(G * g).repeat_interleave(k)
    src = torch.full((E_l * rows + 1,), G * g, dtype=torch.long)
    src.scatter_(0, torch.where(keep, dest, E_l * rows), token)
    xe = torch.cat([x.reshape(G * g, d), x.new_zeros((1, d))])[src[:-1]].reshape(E_l, rows, d)
    h = torch.nn.functional.silu(xe @ p["w_gate"]) * (xe @ p["w_up"])
    ye = (h @ p["w_down"]).reshape(E_l * rows, d)
    y = ye[torch.where(keep, dest, 0)].reshape(G, g, k, d)
    w = weights.to(x.dtype).float()
    if k > 2:
        return (w[..., None] * y.float()).sum(-2).reshape(B, S, d)
    out = w[..., 0, None] * y[..., 0, :].float()
    for j in range(1, k):
        out = out + w[..., j, None] * y[..., j, :].float()
    return out.reshape(B, S, d)


def _deepseek_moe(**kw):
    """Reduced mixtral's widths with DeepSeekMoE's router: 16 experts top 8
    among the best 2 of 4 groups, experts 32 wide, no shared expert."""
    _, tcfg = configs(**kw)
    return dataclasses.replace(tcfg, moe=DeepSeekMoEConfig(
        n_experts=16, top_k=8, n_groups=4, topk_groups=2, routed_scale=2.5, n_shared=0,
        d_expert=32))


MOE_CPU_CASES = {
    # (config, dtype, S, held experts (first, E_l) or None for all)
    "mixtral_bf16_drops": (lambda: configs(moe_capacity_factor=1.0)[1], "bfloat16", 16, None),
    "mixtral_f32_held_slice": (lambda: configs(moe_capacity_factor=1.25, moe_group=4)[1],
                               "float32", 16, (1, 2)),
    "deepseek_bf16_k8_drops": (lambda: _deepseek_moe(moe_capacity_factor=1.0), "bfloat16",
                               16, None),
    "deepseek_decode_held_slice": (lambda: _deepseek_moe(), "bfloat16", 1, (4, 8)),
}


@pytest.mark.parametrize("case", sorted(MOE_CPU_CASES))
def test_moe_cpu_route_gives_the_indexing_bits(case):
    """The ops' CPU route (``ref.moe_dispatch_ref``, ``ref.moe_combine_ref``
    under autograd) gives the output and every gradient of the gathers the
    layer ran before, bit for bit, at k = 2 and k = 8, with drops and with a
    slice of the experts held; it launches and counts nothing."""
    make_cfg, dtype, S_, held = MOE_CPU_CASES[case]
    cfg = dataclasses.replace(make_cfg(), dtype=dtype)
    gen = torch.Generator().manual_seed(5)
    p = L.init_moe(gen, cfg)
    if "e_bias" in p:
        p["e_bias"] = torch.randn(p["e_bias"].shape, generator=gen) * 0.1
    first = 0
    if held is not None:
        first, E_l = held
        p = {n: w[first:first + E_l] if n.startswith("w_") else w for n, w in p.items()}
    x = torch.randn((B, S_, cfg.d_model), generator=gen).to(L.DTYPES[dtype])
    cot = torch.randn((B, S_, cfg.d_model), generator=gen)
    before = {n: getattr(getattr(ops, n), a) for n in ("moe_dispatch", "moe_combine")
              for a in ("launches", "bwd_launches")}
    got = []
    for fn in (L._moe_local, _moe_local_by_indexing):
        leaves_ = {n: w.clone().requires_grad_(w.is_floating_point()) for n, w in p.items()}
        xg = x.clone().requires_grad_()
        out = fn(leaves_, xg, cfg, first)
        wrt = [xg] + [w for w in leaves_.values() if w.requires_grad]
        grads = torch.autograd.grad((out * cot).sum(), wrt, allow_unused=True)
        got.append((out, grads))
    (out, grads), (want, want_grads) = got
    route = (L.moe_route_grouped(p["router"], p["e_bias"], x, cfg) if "e_bias" in p
             else L.moe_route(p["router"], x, cfg))
    assert held is not None or S_ == 1 or bool((~route.keep).any())   # drops occur
    assert torch.equal(out, want)
    for a, b in zip(grads, want_grads, strict=True):
        assert (a is None and b is None) or torch.equal(a, b)
    assert before == {n: getattr(getattr(ops, n), a) for n in ("moe_dispatch", "moe_combine")
                      for a in ("launches", "bwd_launches")}

"""The plain reference against the program's CPU path at small widths, in
float32, where the two must agree to rounding."""
from __future__ import annotations


import pytest
import torch

from portbench import harness as H
from portbench.kinds import serve as S
from portbench.kinds import train as T
from portbench.reference import lm as ref
from portbench.tests.conftest import tiny_cell, tiny_config

CPU = torch.device("cpu")


def f32(name, **kw):
    return tiny_config(name, dtype="float32", remat=False, **kw)


def made(c, seed=5):
    cfg = H.model_config(c)
    return cfg, H.make_params(c, cfg, seed, CPU)


@pytest.mark.parametrize("name", ["mixtral_8x7b", "jamba_1_5_large_398b"])
def test_loss_and_gradients(name):
    from repro_torch.models import model as M
    from repro_torch.tree import leaves, map_tree

    c = f32(name, moe_group=8)                       # groups of 8: capacity drops happen
    cfg, params = made(c)
    b = T.feed(c, {"batch": 2, "seq": 16}, 9, 0, CPU)
    p = map_tree(lambda t: t.detach().requires_grad_(), params)
    got = M.loss_fn(p, cfg, b["tokens"], b["labels"])
    g_got = torch.autograd.grad(got, leaves(p))
    q = [t.detach().clone().requires_grad_() for t in ref.leaves(params)]
    want = ref.loss(ref.rebuild(params, q), c, b["tokens"], b["labels"], ref.Precision())
    g_want = torch.autograd.grad(want, q)
    assert got.item() == pytest.approx(want.item(), rel=1e-5)
    for a, w in zip(g_got, g_want, strict=True):
        assert (a - w).abs().max() <= 1e-4 * w.abs().max() + 1e-7


def test_held_experts_route_over_the_whole_router():
    """Four experts held of eight: the program and the reference route over
    all eight and add the held ones' part."""
    from repro_torch.models import layers as L

    c = f32("jamba_1_5_large_398b")
    assert c["router_experts"] == 8 and c["n_experts"] == 4
    cfg, params = made(c)
    moe_block = params["blocks"][1]
    assert moe_block["mlp"]["w_gate"].shape[1] == 4 and moe_block["mlp"]["router"].shape[-1] == 8
    x = torch.randn(2, 16, c["d_model"], generator=torch.Generator().manual_seed(1))
    lp = {k: v[0] for k, v in moe_block["mlp"].items()}
    got = L.moe_mlp(lp, x, cfg)
    want = ref.moe(moe_block["mlp"], 0, x, c, ref.Precision(), capacity=True)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert (want == 0).all(dim=-1).any()              # some tokens chose only absent experts


def test_mamba_mixer():
    from repro_torch.models import ssm

    c = f32("jamba_1_5_large_398b")
    cfg, params = made(c)
    mp = params["blocks"][0]["mixer"]
    x = torch.randn(2, 12, c["d_model"], generator=torch.Generator().manual_seed(2))
    got, _ = ssm.mamba({k: v[0] for k, v in mp.items()}, x, cfg)
    want = ref.mamba(mp, 0, x, c, ref.Precision())
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("workload,micro", [("mixtral_8x7b.train_accum8", 2),
                                            ("mixtral_8x7b.train_b4s512", 1)])
def test_the_first_steps_agree(workload, micro):
    """The driver's own comparison, program against reference, reads rounding
    only at float32."""
    cell = tiny_cell(workload, f32("mixtral_8x7b", n_layers=2), batch=4, seq=16,
                     microbatches=micro)
    c, tr = cell["config"], cell["traffic"]
    prog = T.Program(c, tr, 11, CPU)
    while prog.steps_done < tr["checked_steps"]:
        prog.job()
    got = prog.first_steps()
    want = T.reference_steps(c, tr, 11, CPU, ref.Precision())
    numbers = T.compare(got, want)
    assert numbers["loss"] < 1e-6 and numbers["grad"] < 1e-4 and numbers["change"] < 1e-3


def test_served_tokens_agree():
    cell = tiny_cell("jamba_1_5_large_398b.serve_b256", f32("jamba_1_5_large_398b"), batch=3,
                     prompt_len=4, gen_len=5)
    c, tr = cell["config"], cell["traffic"]
    prog = S.Program(c, tr, 13, CPU)
    jobs = [prog.job(j) for j in range(2)]
    assert all(j["tokens"].shape == (3, 5) for j in jobs)
    assert S.gaps(c, tr, prog.params, jobs, ref.Precision(), CPU)["served"].max() < 1e-4


def test_weights_repeat_from_the_seed():
    c = tiny_config("jamba_1_5_large_398b")
    cfg = H.model_config(c)
    a, b = (ref.leaves(H.make_params(c, cfg, 2**31 + 77, CPU)) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b, strict=True))
    other = ref.leaves(H.make_params(c, cfg, 2**31 + 78, CPU))
    assert not torch.equal(a[0], other[0])
    assert {t.dtype for t in a} == {torch.bfloat16, torch.float32}

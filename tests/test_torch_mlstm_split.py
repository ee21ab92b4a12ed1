"""The mLSTM kernels' arithmetic, on the CPU.

On the card ``ops.mlstm_chunk`` runs two kernels (``csrc/mlstm_chunk.cu``):
a scores kernel writes, per (b, h, chunk) padded to a 64-row tile, the
masked and decayed scores P = (q·kᵀ) ⊙ D, fcum, the weights
W_t = i_t e^(ftot − fcum_t), the row sums of P and u = Σ_t k_t W_t; a state
kernel then walks the chunks for each 32-column value tile of C, taking
y = e^fcum ⊙ (q·C) + P·v, C ← e^ftot C + kᵀ·(W ⊙ v) and n ← e^ftot n + u.
Every product is 3xTF32: a = hi + lo, hi rounded to TF32 as ``cvt.rna``
does and lo the remainder, which the tensor core reads with its low 13
bits dropped, and a·b = lo_a·hi_b + hi_a·lo_b + hi_a·hi_b with fp32 sums.
``two_pass`` renders that in plain PyTorch (it is not on the port's path)
and is held against the plain version and the JAX reference at atol 5e-5 /
rtol 5e-4 (tests/test_kernels.py). The backward (``csrc/mlstm_chunk_bwd.cu``)
takes its products the same way: ``einsum_tf32`` renders that in the plain
backward, held per gradient to the card's limit, |err| <= 1e-4·(|ref| +
rms(ref)) against float64. Its sums are fp32 sums rounded to nearest: the
tensor core's own accumulation, which truncates, is not modelled here (the
card test ``test_mlstm_bwd_kernel_adds_its_deep_sums_in_fp32_on_card`` in
tests/test_torch_cuda.py holds the kernel's remedy for it).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import mlstm_chunk_ref as jax_mlstm_ref
from repro_torch.kernels.mlstm_chunk import MAX_CHUNK, P_STRIDE, record_floats
from repro_torch.kernels.ref import mlstm_chunk_bwd_ref, mlstm_chunk_ref

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CM = MAX_CHUNK   # rows of every chunk tile
VT = 32          # value columns of C per state block
TOL = {"atol": 5e-5, "rtol": 5e-4}
MLSTM_BWD_TOL = 1e-4  # the backward's elementwise limit on the card (tests/test_torch_cuda.py)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 stored mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``: add half of the last kept bit
    to the magnitude's bits, then clear the 13 dropped bits."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """fp32 with its 13 low mantissa bits cleared: how the tensor core reads
    an fp32 bit pattern as a TF32 operand."""
    bits = x.contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' split: hi = TF32 rounding of x, lo = x − hi as read by mma."""
    hi = tf32(x)
    return hi, tf32_truncated(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as three TF32 products with fp32 sums (each product of two
    TF32 values is exact in fp32)."""
    (ah, al), (bh, bl) = split(a), split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 product: what plain TF32 tensor cores give."""
    return tf32(a) @ tf32(b)


def tiles(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, S, H, ...) -> (B, H, n_chunks, 64, ...): chunk j's positions in
    rows 0 .. chunk-1 of tile j, zeros past S and past the chunk."""
    B, S, H = x.shape[:3]
    n = -(-S // chunk)
    x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 2) + (0, n * chunk - S))
    x = x.reshape(B, n, chunk, *x.shape[2:])
    x = torch.nn.functional.pad(x, (0, 0) * (x.dim() - 3) + (0, CM - chunk))
    return x.movedim(3, 1)


def scores_pass(q, k, log_f, i_gate, chunk, mm):
    """The scores kernel: P (B,H,n,64,64), fcum, W and row sums (B,H,n,64),
    and the chunk's addition to n, u = Σ_t k_t W_t (B,H,n,hd), in fp32 FMAs."""
    qt, kt, ft, it = (tiles(t, chunk) for t in (q, k, log_f, i_gate))
    fcum = torch.cumsum(ft, dim=-1)               # padded rows add log f = 0
    causal = torch.tril(torch.ones((CM, CM), dtype=torch.bool))
    rel = (fcum[..., :, None] - fcum[..., None, :]).masked_fill(~causal, float("-inf"))
    P = mm(qt, kt.transpose(-1, -2)) * (torch.exp(rel) * it[..., None, :])
    W = it * torch.exp(fcum[..., -1:] - fcum)
    return P, fcum, W, P.sum(dim=-1), (kt * W[..., None]).sum(dim=-2)


def two_pass(q, k, v, log_f, i_gate, chunk, state=None, mm=mm3):
    """Both kernels' arithmetic: the scores pass, then the state pass over
    each value tile of C in turn, chunk after chunk."""
    B, S, H, hd = q.shape
    P, fcum, W, rs, u = scores_pass(q, k, log_f, i_gate, chunk, mm)
    qt, kt, vt = (tiles(t, chunk) for t in (q, k, v))
    n_chunks = qt.shape[2]
    C = torch.zeros((B, H, hd, hd)) if state is None else state[0].clone()
    nv = torch.zeros((B, H, hd)) if state is None else state[1]
    ys = torch.empty((B, H, n_chunks, CM, hd))
    for v0 in range(0, hd, VT):
        c = C[..., v0:v0 + VT]
        n = nv
        for j in range(n_chunks):
            e = torch.exp(fcum[:, :, j])                             # (B, H, 64)
            vj = vt[:, :, j, :, v0:v0 + VT]
            y = e[..., None] * mm(qt[:, :, j], c) + mm(P[:, :, j], vj)
            nrm = e * (qt[:, :, j] @ n[..., None])[..., 0] + rs[:, :, j]
            ys[:, :, j, :, v0:v0 + VT] = y / torch.clamp(nrm.abs(), min=1.0)[..., None]
            g = torch.exp(fcum[:, :, j, -1])[..., None, None]
            c = g * c + mm(kt[:, :, j].transpose(-1, -2), W[:, :, j, :, None] * vj)
            n = g[..., 0] * n + u[:, :, j]
        C[..., v0:v0 + VT] = c
    y = ys[:, :, :, :chunk].movedim(1, 3).reshape(B, n_chunks * chunk, H, hd)[:, :S]
    return y, (C, n)


def inputs(B, S, H, hd, with_state, seed=3):
    """The model's scales: q carries hd^-0.5, forget gates near sigmoid(2)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    q = rng.standard_normal((B, S, H, hd), dtype=f32) * f32(hd ** -0.5)
    k, v = (rng.standard_normal((B, S, H, hd), dtype=f32) for _ in range(2))
    log_f = np.log(1 / (1 + np.exp(-(rng.standard_normal((B, S, H), dtype=f32) + 2)))).astype(f32)
    i_gate = (1 / (1 + np.exp(-rng.standard_normal((B, S, H), dtype=f32)))).astype(f32)
    state = ((rng.standard_normal((B, H, hd, hd), dtype=f32) * f32(0.1),
              rng.standard_normal((B, H, hd), dtype=f32)) if with_state else None)
    return q, k, v, log_f, i_gate, state


def jax_reference(q, k, v, log_f, i_gate, chunk):
    """JAX's oracle (zero state, S a multiple of the chunk): a ragged S is
    padded with positions that leave the state alone, their outputs cut."""
    S = q.shape[1]
    pad = -S % chunk
    pq, pk, pv = (np.pad(t, ((0, 0), (0, pad), (0, 0), (0, 0))) for t in (q, k, v))
    pf, pi = (np.pad(t, ((0, 0), (0, pad), (0, 0))) for t in (log_f, i_gate))
    y = jax_mlstm_ref(*(jnp.asarray(t) for t in (pq, pk, pv, pf, pi)), chunk=chunk)
    return np.asarray(y)[:, :S]


@pytest.mark.parametrize("B,S,H,hd,chunk,with_state", [
    (2, 128, 2, 32, 64, False),
    (1, 100, 3, 64, 32, False),    # ragged S, chunk 32
    (2, 50, 2, 64, 64, False),     # S < chunk
    (1, 65, 1, 512, 64, True),     # xlstm-350m's head dim, ragged second chunk, a state
    (1, 128, 1, 512, 64, False),
    (1, 96, 1, 512, 32, False),    # chunk 32 at hd 512
    (2, 77, 2, 32, 64, True),
    (1, 1, 2, 64, 64, True),       # one position
])
def test_two_pass_matches_plain_version_and_jax(B, S, H, hd, chunk, with_state):
    q, k, v, log_f, i_gate, state = inputs(B, S, H, hd, with_state)
    c = min(chunk, S)  # as ops.mlstm_chunk clamps it
    tq, tk, tv, tf, ti = (torch.from_numpy(t) for t in (q, k, v, log_f, i_gate))
    ts = None if state is None else tuple(torch.from_numpy(t) for t in state)
    y, (C, n) = two_pass(tq, tk, tv, tf, ti, c, ts)
    ry, (rC, rn) = mlstm_chunk_ref(tq, tk, tv, tf, ti, chunk=c, state=ts)
    for got, want in ((y, ry), (C, rC), (n, rn)):
        torch.testing.assert_close(got, want, **TOL)
    if state is None:
        np.testing.assert_allclose(y.numpy(), jax_reference(q, k, v, log_f, i_gate, c),
                                   atol=TOL["atol"], rtol=TOL["rtol"])


@pytest.mark.parametrize("S,chunk", [(128, 64), (100, 32), (50, 50), (1, 1)])
def test_score_workspace_is_causal_and_zero_past_the_chunk(S, chunk):
    q, k, _, log_f, i_gate, _ = inputs(1, S, 2, 32, False, seed=4)
    P, fcum, W, rs, u = scores_pass(*(torch.from_numpy(t) for t in (q, k, log_f, i_gate)),
                                    chunk, mm3)
    n_chunks = -(-S // chunk)
    assert P.shape == (1, 2, n_chunks, CM, CM) and rs.shape == W.shape == fcum.shape
    assert record_floats(32) == CM * P_STRIDE + 3 * CM + 32 and P_STRIDE >= CM  # P, gates, u
    assert torch.equal(P.triu(1), torch.zeros_like(P))        # nothing above the diagonal
    last = S - (n_chunks - 1) * chunk                          # real rows of the last tile
    assert torch.equal(P[:, :, -1, last:], torch.zeros_like(P[:, :, -1, last:]))
    assert torch.equal(W[:, :, -1, last:], torch.zeros_like(W[:, :, -1, last:]))
    assert torch.equal(fcum[..., -1], fcum[:, :, :, min(chunk, S) - 1])  # ftot
    torch.testing.assert_close(rs, P.sum(dim=-1))
    assert u.shape == (1, 2, n_chunks, 32)


def test_tf32_rounds_to_nearest_with_ties_away_from_zero():
    one = 1.0
    x = torch.tensor([one + 2**-11, -(one + 2**-11), one + 2**-12, one + 3 * 2**-11,
                      one + 2**-11 + 2**-20, 3.0, 0.0, -0.0], dtype=torch.float32)
    want = torch.tensor([one + 2**-10, -(one + 2**-10), one, one + 2**-9,
                         one + 2**-10, 3.0, 0.0, -0.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(5).standard_normal(10_000, dtype=np.float32))
    hi, lo = split(r)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32_truncated(lo), lo)
    assert ((hi + lo - r).abs() <= r.abs() * 2.0**-20).all()   # ~21 bits kept of 24
    assert ((hi - r).abs() <= r.abs() * 2.0**-11).all()


def test_one_tf32_product_is_not_enough_at_hd_512():
    """Why the kernels take three products: one TF32 product keeps about 11
    bits of each operand, and at hd 512 its error passes the tolerance."""
    q, k, v, log_f, i_gate, state = inputs(1, 128, 1, 512, True, seed=6)
    t = [torch.from_numpy(a) for a in (q, k, v, log_f, i_gate)]
    ts = tuple(torch.from_numpy(a) for a in state)
    ry, (rC, _) = mlstm_chunk_ref(*t, chunk=64, state=ts)
    errs = {}
    for name, mm in (("1xTF32", mm1), ("3xTF32", mm3)):
        y, (C, _) = two_pass(*t, 64, ts, mm=mm)
        errs[name] = (y - ry).abs().max().item(), (C - rC).abs().max().item()
        print(f"hd 512, {name}: max abs err y {errs[name][0]:.3g}, C {errs[name][1]:.3g}")
    with pytest.raises(AssertionError):
        y1, (C1, _) = two_pass(*t, 64, ts, mm=mm1)
        torch.testing.assert_close(y1, ry, **TOL)
        torch.testing.assert_close(C1, rC, **TOL)
    assert max(errs["3xTF32"]) < 5e-5 < max(errs["1xTF32"])


def einsum_tf32(products: int):
    """``torch.einsum`` of two fp32 operands as a tensor core takes its
    products: three TF32 products (lo·hi + hi·lo + hi·hi) or one. The sums
    are fp32 sums rounded to nearest, not the tensor core's truncated ones."""
    plain = torch.einsum

    def einsum(eq, a, b):
        if products == 1:
            return plain(eq, tf32(a), tf32(b))
        (ah, al), (bh, bl) = split(a), split(b)
        return plain(eq, al, bh) + plain(eq, ah, bl) + plain(eq, ah, bh)

    return einsum


@pytest.mark.parametrize("S,chunk,with_state", [
    (128, 64, True),     # xlstm-350m's head dim and chunk, a state and final-state gradients
    (77, 40, False),     # a chunk that is no multiple of 16, ragged
])
def test_backward_in_3xtf32_holds_the_limit_at_hd_512(monkeypatch, S, chunk, with_state):
    """Every product of the backward as three TF32 products holds each
    gradient to the card's limit against float64; one TF32 product does not."""
    q, k, v, log_f, i_gate, state = inputs(1, S, 1, 512, with_state, seed=7)
    t = [torch.from_numpy(a) for a in (q, k, v, log_f, i_gate)]
    ts = None if state is None else tuple(torch.from_numpy(a) for a in state)
    y, _ = mlstm_chunk_ref(*t, chunk=chunk, state=ts)
    rng = np.random.default_rng(8)
    dy = torch.from_numpy(rng.standard_normal(y.shape, dtype=np.float32))
    dC, dn = ((torch.from_numpy(rng.standard_normal((1, 1, 512, 512), dtype=np.float32)),
               torch.from_numpy(rng.standard_normal((1, 1, 512), dtype=np.float32)))
              if with_state else (None, None))
    as64 = lambda x: None if x is None else x.double()  # noqa: E731
    exact = mlstm_chunk_bwd_ref(*(x.double() for x in (*t, y, dy)), chunk=chunk,
                                state=None if ts is None else tuple(map(as64, ts)),
                                dC=as64(dC), dn=as64(dn))

    def over_tol(a, want):
        limit = MLSTM_BWD_TOL * (want.abs() + want.square().mean().sqrt())
        return ((a.double() - want).abs() / limit).max().item()

    worst = {}
    for products in (3, 1):
        with monkeypatch.context() as m:
            m.setattr(torch, "einsum", einsum_tf32(products))
            got = mlstm_chunk_bwd_ref(*t, y, dy, chunk=chunk, state=ts, dC=dC, dn=dn)
        worst[products] = max(over_tol(a, e) for a, e in zip(got, exact, strict=True))
        print(f"hd 512, S {S}, chunk {chunk}, {products}xTF32: worst err/tol {worst[products]:.3g}")
    assert worst[3] <= 1.0 < worst[1]

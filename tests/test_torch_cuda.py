"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA device and skips without one (the kernels have no CPU mode).
Imports neither JAX nor ``repro``, so it runs where only the port is
installed; ``tests/conftest.py`` imports JAX, so on such a machine run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: attention f32 2e-5, bf16 2e-2; mLSTM atol 5e-5, rtol 5e-4
(tests/test_kernels.py), against the plain version computed in f32 from
the same inputs. The rows' log-sum-exp that the flash forward writes for
the backward: abs 1e-4 against ``flash_attention_lse_ref`` (fp32
statistics of values of order log S; summation order). The flash backward,
reading that log-sum-exp, per gradient: elementwise against its fp32
formulas on the same inputs and forward output (the kernel's arithmetic),
|err| <= tol·(|ref| + rms(ref)) with tol bf16 1e-2 (about one bf16 ulp)
and f32 1e-4; and max abs error <= tol x max(1, max|ref|), tol f32 1e-4 and
bf16 3e-2, against autograd of the plain version; two runs on the same
inputs give the same bits. The 3xTF32 route (f32 at every head dim, bf16 at
hd 16/32) is also held at the 16-row tile edges (S = 1, 7, 37, 200, 1000),
at G = 1 and 12, forward and backward, and its forward twice to the bit.
Both routes hold llama3-405b's G = 16 (32 heads over 2), forward, lse and
backward, bf16 and f32. The mLSTM backward, per gradient, elementwise
against its plain version ``mlstm_chunk_bwd_ref`` on the same inputs and
forward output, |err| <= 1e-4·(|ref| + rms(ref)) (the f32 flash
backward's rule), against the plain version in float64 (the truth) and in
fp32 (the plain version as the port runs it), also at a chunk of 40 (no
multiple of the 16-row mma tile) and with the gates where d log f's terms
cancel most (log f near 0, i near 1); two runs give the same bits, and
saving the states for it leaves the forward's output as it was, to the
bit. A reduced f32
model's train step on the card (smollm, xLSTM with and without ``remat``,
and whisper with and without it): loss 1e-4, params 2e-3 against the same
step on the CPU. The
MoE MLP on the card against the same call on the CPU (f32, with dropped
assignments): the same routing, rel 1e-5. The mamba mixer (plain
PyTorch) at d_model 1024 on the card against the same call on the CPU (f32,
S=512, a non-zero state): output and both states rel 1e-5; stepped one
token at a time there against its forward, rel 1e-3. The paper's
workloads (``repro_torch.apps``, library payloads) on the card: each within
``launch.apps``'s limits of its float64 reference there, with the same
``charged_ms`` and ``kv_stats`` as on the CPU. Whisper's attention: the
flash forwards and backwards at Sq != Skv (cross-attention, no mask) and
the encoder's 1500 frames (the backward held as above), decode over its
1500-frame cross cache, the refusal of a mask at Sq != Skv by the
wrappers and by the C entry points, and reduced whisper's forward and
decode on the card against the CPU (rel 1e-5). AdamW's kernels against its
plain version on the same CUDA tensors, p and g each bf16 or fp32, with and
without the gradients' bf16 round trip and the clip, over leaves of 37 ×
129 (no multiple of 8), a 9.4 M stack (several grid strides), a 1-d leaf
(no decay) and a view whose start is not 16-byte aligned: the grad norm rel
1e-6 (the sums run in another order), fp32 outputs within
``ADAMW_F32_ULPS`` ulps (the clip scale inherits the norm's last bit and
the moments' squares double it), bf16 parameters within one bf16 ulp; the
inputs left as they were, two calls equal to the bit, no synchronisation,
2 op calls a leaf and 1 a step; and the sharded route's per-shard sums,
added and finalized, give the unsharded route's bits. The MoE dispatch and
combine kernels and their backwards against the plain gathers on the same
CUDA tensors, at mixtral's training shape, DeepSeek-V3's decode shape (8 of
256 experts held from the ninth on), capacity 1 with every token on one
expert, a held slice in f32 and top 8 in f32: forwards and dye equal to the
bit, dx equal at k <= 2, the rest within the bounds of fp32 sums in another
order; two calls equal to the bit, each counted; and replayed in a CUDA
graph, with no host sync, as the eager calls give. The fake kernels' FLOP
formulas equal the kernel check's bound operations (``chip_smoke.py``).

The configurations on the card: decode against one forward at each
configuration's full width, its depth cut (bf16 within
``tests/test_torch_bf16.py``'s limits, MoE routings flipped within its
share; f32 rel 1e-3), with one flash launch per attention layer and one
decode launch per layer and step; reduced models served through the engine
on the card and the CPU, the same greedy tokens; training through the
engine's workflow at full width (injected failures, the loss falling, the
kernels' launches per step run, mixtral's peak within 5 % of its
reckoning); one mixtral step run twice on one state, equal to the bit; and
a dry-run cell that fits one H100 run there against its traces (FLOPs,
kernel calls, argument bytes, the peak) and as DTensors on the card's 1×1
NCCL mesh, equal to the plain step to the bit.
"""
import dataclasses
import gc
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import adamw as adamw_kernel
from repro_torch.kernels import decode_attention as dec_kernel
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (
    decode_attention_ref,
    flash_attention_bwd_fp32_ref,
    flash_attention_bwd_ref,
    flash_attention_lse_ref,
    flash_attention_ref,
    mlstm_chunk_bwd_ref,
    mlstm_chunk_ref,
    moe_combine_ref,
    moe_dispatch_ref,
)
from repro_torch.kernels import mlstm_chunk as mlstm_kernel
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.train import build_train_step, synthetic_batch
from repro_torch.tree import leaves, map_tree

from _moe_routes import routes_recorded, routing_flips

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
BWD_ELT_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
LSE_TOL = 1e-4
MLSTM_BWD_TOL = 1e-4
ADAMW_F32_ULPS = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,K,hd,causal,window", [
    (128, 2, 2, 16, True, None), (200, 6, 2, 32, False, None),
    (333, 15, 5, 64, True, 100), (256, 8, 1, 128, True, None),
    (130, 12, 1, 192, True, None),   # nemotron-4-340b's hd 192 and G = 12
    (64, 20, 20, 64, True, None),    # whisper's decoder self-attention: causal at G = 1
])
def test_flash_kernel_on_card(cuda, dtype, S, H, K, hd, causal, window):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(TORCH_DT[dtype])
               for s in [(2, S, H, hd), (2, S, K, hd), (2, S, K, hd)])
    n = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n + 1
    ref = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref, atol=TOL[dtype], rtol=TOL[dtype])


# the 3xTF32 route (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu): f32 at every head
# dim, bf16 at hd 16 and 32
ROUTE_3XTF32 = [("float32", 16), ("float32", 32), ("float32", 64), ("float32", 128),
                ("float32", 192), ("bfloat16", 16), ("bfloat16", 32)]
# lengths at the edges of the 16-row mma tiles and of the 64- and 128-row q tiles
EDGE_LENGTHS = [1, 7, 37, 200, 1000]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", ROUTE_3XTF32)
@pytest.mark.parametrize("S", EDGE_LENGTHS)
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48), (False, None)])
@pytest.mark.parametrize("H,K", [(12, 1), (4, 4)])  # G = 12 (nemotron's), G = 1
def test_flash_3xtf32_forward_on_card(cuda, dtype, hd, S, causal, window, H, K):
    """The 3xTF32 forward against the plain version at the tile edges, with
    the rows' log-sum-exp; the same bits when asked again."""
    assert flash_kernel.route(TORCH_DT[dtype], hd) == "3xtf32"
    g = torch.Generator(device=cuda).manual_seed(15)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(TORCH_DT[dtype])
               for s in [(2, S, H, hd), (2, S, K, hd), (2, S, K, hd)])
    n = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n + 1
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
    again, lse = _forward_with_lse(q, k, v, causal, window)
    assert torch.equal(again, out)
    torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, causal=causal, window=window),
                               atol=LSE_TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", ROUTE_3XTF32)
# 37 and 200 run in test_flash_bwd_kernel_on_card, Sq = 1 in CROSS_CASES: at S = 1 the one
# visible key leaves dq and dk exactly zero, rounding noise against a limit that vanishes
@pytest.mark.parametrize("S", [7, 1000])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48), (False, None)])
@pytest.mark.parametrize("H,K", [(12, 1), (4, 4)])
def test_flash_3xtf32_backward_on_card(cuda, dtype, hd, S, causal, window, H, K):
    """The 3xTF32 backward at the tile edges, at G = 12 and G = 1, held as
    ``test_flash_bwd_kernel_on_card`` holds it."""
    g = torch.Generator(device=cuda).manual_seed(16)
    q, k, v, do = (torch.randn(s, generator=g, device=cuda).to(TORCH_DT[dtype])
                   for s in [(2, S, H, hd), (2, S, K, hd), (2, S, K, hd), (2, S, H, hd)])
    _hold_flash_bwd(q, k, v, do, causal, window, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("S,causal,window", [(200, True, None), (37, True, 24),
                                             (200, False, None)])
def test_flash_at_g16_on_card(cuda, dtype, hd, S, causal, window):
    """llama3-405b's grouping, G = 16 (128 heads over 8; here 32 over 2):
    the forward and its rows' log-sum-exp against the plain version, and the
    backward held as ``test_flash_bwd_kernel_on_card`` holds it, on both
    routes (bf16 ``wgmma``, f32 3xTF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(27)
    q, k, v, do = (torch.randn(s, generator=g, device=cuda).to(TORCH_DT[dtype])
                   for s in [(2, S, 32, hd), (2, S, 2, hd), (2, S, 2, hd), (2, S, 32, hd)])
    out, lse = _forward_with_lse(q, k, v, causal, window)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, causal=causal, window=window),
                               atol=LSE_TOL, rtol=0)
    _hold_flash_bwd(q, k, v, do, causal, window, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", ROUTE_3XTF32 + [("bfloat16", 64), ("bfloat16", 192)])
def test_flash_forward_is_deterministic_on_card(cuda, dtype, hd):
    """Two forward launches on the same inputs give the same bits, output and
    log-sum-exp."""
    g = torch.Generator(device=cuda).manual_seed(17)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(TORCH_DT[dtype])
               for s in [(2, 300, 12, hd), (2, 300, 2, hd), (2, 300, 2, hd)])
    first = _forward_with_lse(q, k, v, True, None)
    again = _forward_with_lse(q, k, v, True, None)
    for a, b in zip(first, again, strict=True):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,K,hd", [(100, 15, 5, 64), (512, 8, 2, 32),
                                      (64, 16, 1, 128), (77, 4, 4, 16),
                                      (100, 12, 1, 192), (70, 8, 8, 192),
                                      (32, 20, 20, 64)])
def test_decode_kernel_on_card(cuda, dtype, S, H, K, hd):
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(TORCH_DT[dtype])
               for s in [(4, H, hd), (4, S, K, hd), (4, S, K, hd)])
    lens = torch.tensor([1, S // 3, S, S + 9], dtype=torch.int32, device=cuda)
    out = ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    ref = decode_attention_ref(q.float(), k.float(), v.float(), lens)
    torch.testing.assert_close(out.float(), ref, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128, 192])
@pytest.mark.parametrize("S,H,K,causal,window", [
    (512, 15, 5, True, None),     # G = 3, S a multiple of the 128-row q tile
    (1000, 16, 2, True, None),    # G = 8, ragged S
    (333, 15, 5, True, 100),      # ragged S, window
    (1024, 16, 2, True, 256),     # G = 8, window
    (333, 6, 2, False, None),     # not causal, ragged S
    (100, 3, 1, True, None),      # S shorter than one q tile
    (150, 6, 3, True, None),      # odd count of 64-row tiles: one block pairs a tile with itself
    (512, 20, 20, True, None),    # whisper's decoder self-attention: causal at G = 1
])
def test_flash_tensor_core_kernel_on_card(cuda, hd, S, H, K, causal, window):
    assert flash_kernel.route(torch.bfloat16, hd) == "wgmma"
    g = torch.Generator(device=cuda).manual_seed(8)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
               for s in [(2, S, H, hd), (2, S, K, hd), (2, S, K, hd)])
    n = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n + 1
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,hd,lens", [
    (4, 2048, 15, 5, 64, [1, 300, 2048, 5000]),  # splits past kv_len, kv_len 1 and > S
    (1, 8192, 15, 5, 64, [8191]),                # one long request
    (2, 1000, 64, 8, 128, [999, 17]),            # G = 8, ragged S
    (3, 700, 16, 1, 32, [700, 1, 650]),          # G = 16
    (4, 64, 15, 5, 64, [63, 63, 63, 63]),        # one split: the serving shape
    (2, 2048, 96, 8, 192, [2047, 700]),          # nemotron-4-340b: hd 192, G = 12
    (3, 600, 16, 4, 192, [600, 1, 333]),         # hd 192, G = 4
])
def test_decode_split_kernel_on_card(cuda, dtype, B, S, H, K, hd, lens):
    n_split = dec_kernel.split_plan(B, K, S)[0]
    assert (n_split == 1) == (S <= dec_kernel.SPLIT_KEYS)
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(TORCH_DT[dtype])
               for s in [(B, H, hd), (B, S, K, hd), (B, S, K, hd)])
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    n = ops.decode_attention.launches
    out = ops.decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == n + 1  # the merge kernel is not a second call
    ref = decode_attention_ref(q.float(), k.float(), v.float(), kv_len)
    torch.testing.assert_close(out.float(), ref, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,hd,lens", [
    (4, 2048, 15, 5, 64, [0, 300, 2048, 5000]),  # split: an empty row, kv_len > S
    (4, 64, 15, 5, 64, [63, 0, 1, 64]),          # one split
    (2, 2048, 96, 8, 192, [2047, 0]),            # hd 192, G = 12
])
def test_decode_kernel_writes_each_rows_logsumexp_on_card(cuda, dtype, B, S, H, K, hd, lens):
    """The rows' log-sum-exp the sequence-parallel decode merges by: the
    kernel's against its plain version's (TOL), -inf where a row sees no key
    (kv_len 0); the output is the one the kernel gives without it."""
    g = torch.Generator(device=cuda).manual_seed(26)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(TORCH_DT[dtype])
               for s in [(B, H, hd), (B, S, K, hd), (B, S, K, hd)])
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    n = ops.decode_attention.launches
    out, lse = ops.decode_attention(q, k, v, kv_len, with_lse=True)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == n + 1
    assert torch.equal(out, ops.decode_attention(q, k, v, kv_len))
    _, want = decode_attention_ref(q.float(), k.float(), v.float(), kv_len, with_lse=True)
    empty = kv_len <= 0
    assert torch.equal(torch.isneginf(lse), empty[:, None].expand(B, H))
    torch.testing.assert_close(lse[~empty], want[~empty], atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,chunk,with_state", [
    (2, 128, 2, 32, 64, False), (1, 256, 4, 64, 64, True),
    (2, 100, 3, 64, 32, False),       # ragged S, smaller chunk
    (1, 50, 2, 64, 64, True),         # S < chunk: the chunk clamps to S
    (1, 200, 2, 32, 64, False),
    (2, 512, 4, 512, 64, False),      # xlstm-350m's mLSTM shape
    (2, 300, 4, 512, 64, True),       # ragged, with a state
    (2, 256, 4, 512, 32, False),      # hd 512 with chunk 32
    (1, 65, 4, 512, 64, True),        # one (b, h) per value-tile group, ragged second chunk
    (2, 1, 3, 64, 64, True),          # one position
])
def test_mlstm_kernel_on_card(cuda, B, S, H, hd, chunk, with_state):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda)

    q, k, v = randn(B, S, H, hd) * hd ** -0.5, randn(B, S, H, hd), randn(B, S, H, hd)
    log_f = torch.nn.functional.logsigmoid(randn(B, S, H) + 2.0)
    i_gate = torch.sigmoid(randn(B, S, H))
    state = (randn(B, H, hd, hd) * 0.1, randn(B, H, hd)) if with_state else None
    n = ops.mlstm_chunk.launches
    y, (C, nv) = ops.mlstm_chunk(q, k, v, log_f, i_gate, chunk=chunk, state=state)
    torch.cuda.synchronize()
    assert ops.mlstm_chunk.launches == n + 1
    ry, (rC, rn) = mlstm_chunk_ref(q, k, v, log_f, i_gate, chunk=min(chunk, S), state=state)
    for got, want in ((y, ry), (C, rC), (nv, rn)):
        torch.testing.assert_close(got, want, atol=5e-5, rtol=5e-4)


@pytest.mark.cuda
def test_mlstm_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    g = torch.zeros((1, 8, 2), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        ops.mlstm_chunk(q.bfloat16(), q.bfloat16(), q.bfloat16(), g, g)
    with pytest.raises(ValueError, match="head dim"):
        ops.mlstm_chunk(q[..., :48].contiguous(), q[..., :48].contiguous(),
                        q[..., :48].contiguous(), g, g)
    with pytest.raises(ValueError, match="chunk"):
        ops.mlstm_chunk(torch.zeros((1, 128, 2, 64), device=cuda),
                        torch.zeros((1, 128, 2, 64), device=cuda),
                        torch.zeros((1, 128, 2, 64), device=cuda),
                        torch.zeros((1, 128, 2), device=cuda),
                        torch.zeros((1, 128, 2), device=cuda), chunk=128)


def _forward_with_lse(q, k, v, causal, window):
    """The forward kernel's output and the rows' log-sum-exp it wrote."""
    B, S, H, _ = q.shape  # S: the queries' length
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    return flash_kernel.launch(q, k, v, causal=causal, window=window, lse=lse), lse


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", [("float32", 16), ("float32", 64), ("float32", 192),
                                      ("bfloat16", 32), ("bfloat16", 64),
                                      ("bfloat16", 128), ("bfloat16", 192)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48), (False, None)])
def test_flash_forward_writes_lse_on_card(cuda, dtype, hd, causal, window):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(12)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(TORCH_DT[dtype])
               for s in [(2, 150, 6, hd), (2, 150, 2, hd), (2, 150, 2, hd)])
    out, lse = _forward_with_lse(q, k, v, causal, window)
    torch.cuda.synchronize()
    with torch.no_grad():  # the same output as without the lse
        assert torch.equal(out, ops.flash_attention(q, k, v, causal=causal, window=window))
    torch.testing.assert_close(lse, flash_attention_lse_ref(q, k, causal=causal, window=window),
                               atol=LSE_TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 192])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48), (False, None)])
@pytest.mark.parametrize("H,K", [(2, 2), (6, 2), (8, 1)])  # G = 1, 3, 8
@pytest.mark.parametrize("S", [200, 37])  # ragged: 3 full 64-row tiles and a part; under one
def test_flash_bwd_kernel_on_card(cuda, dtype, hd, causal, window, H, K, S):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(10)
    q, k, v, do = (torch.randn(s, generator=g, device=cuda).to(TORCH_DT[dtype])
                   for s in [(2, S, H, hd), (2, S, K, hd), (2, S, K, hd), (2, S, H, hd)])
    _hold_flash_bwd(q, k, v, do, causal, window, dtype)


def _hold_flash_bwd(q, k, v, do, causal, window, dtype):
    """The backward kernel, fed the forward kernel's output and lse, against
    autograd of the plain version and elementwise against its fp32
    formulas."""
    o, lse = _forward_with_lse(q, k, v, causal, window)  # the backward reads the forward's lse
    n = ops.flash_attention.bwd_launches
    got = ops.flash_attention_bwd(q, k, v, o, do, lse=lse, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.bwd_launches == n + 1
    want = flash_attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    exact = flash_attention_bwd_fp32_ref(q, k, v, o, do, causal=causal, window=window)
    tol = BWD_ELT_TOL[dtype]
    for a, b, e in zip(got, want, exact, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        err = (a.float() - b.float()).abs().max().item()
        assert err <= BWD_TOL[dtype] * max(1.0, b.float().abs().max().item()), err
        limit = tol * e.abs() + tol * e.square().mean().sqrt()
        assert bool(((a.float() - e).abs() <= limit).all()), (a.float() - e).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,S", [("bfloat16", 64, 300), ("bfloat16", 128, 300),
                                        ("bfloat16", 192, 300), ("float32", 64, 200),
                                        ("float32", 128, 300), ("float32", 192, 300)])
def test_flash_bwd_is_deterministic_on_card(cuda, dtype, hd, S):
    """The engine re-runs step tasks: the same inputs must give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(13)
    q, k, v, do = (torch.randn(s, generator=g, device=cuda).to(TORCH_DT[dtype])
                   for s in [(2, S, 16, hd), (2, S, 2, hd), (2, S, 2, hd), (2, S, 16, hd)])
    o, lse = _forward_with_lse(q, k, v, True, None)
    first = ops.flash_attention_bwd(q, k, v, o, do, lse=lse, causal=True, window=None)
    again = ops.flash_attention_bwd(q, k, v, o, do, lse=lse, causal=True, window=None)
    for a, b in zip(first, again, strict=True):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="lse"):
        ops.flash_attention_bwd(q, k, v, o, do, causal=True, window=None)


@pytest.mark.cuda
def test_flash_attention_function_launches_the_backward_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn((1, 100, 6, 64), generator=g, device=cuda).bfloat16().requires_grad_()
    k, v = (torch.randn((1, 100, 2, 64), generator=g, device=cuda).bfloat16().requires_grad_()
            for _ in range(2))
    fwd, bwd = ops.flash_attention.launches, ops.flash_attention.bwd_launches

    def allocations():
        return torch.cuda.memory_stats(cuda)["allocation.all.allocated"]

    with torch.no_grad():  # no grad wanted: the forward alone, and no lse
        before = allocations()
        assert ops.flash_attention(q, k, v).grad_fn is None
        assert allocations() == before + 1  # the output only
    before = allocations()
    out = ops.flash_attention(q, k, v)
    assert allocations() == before + 2  # the output and the rows' lse
    assert out.grad_fn is not None
    out.float().sum().backward()
    assert ops.flash_attention.launches == fwd + 2
    assert ops.flash_attention.bwd_launches == bwd + 1
    for t in (q, k, v):
        assert t.grad is not None and float(t.grad.float().abs().max()) > 0


@pytest.mark.cuda
def test_kernels_without_a_backward_raise_under_grad_on_card(cuda):
    q = torch.randn((2, 4, 16), device=cuda, requires_grad=True)
    cache = torch.randn((2, 8, 2, 16), device=cuda)
    lens = torch.full((2,), 8, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="decode_attention has no backward kernel"):
        ops.decode_attention(q, cache, cache, lens)
    with torch.no_grad():
        ops.decode_attention(q, cache, cache, lens)


# whisper-large-v3's attention: 20 heads over 20, hd 64, 1500 encoder frames; cross-attention
# has queries and keys of different lengths (Sq, Skv) and no mask
CROSS_CASES = [
    (512, 1500, 20, 20, 64),   # the decoder's 512 tokens against the frames
    (37, 1500, 20, 20, 64),    # ragged, under one 64-row q tile
    (1, 1500, 20, 20, 64),     # one token
    (1500, 1500, 20, 20, 64),  # the encoder's self-attention, ragged against the tiles
    (100, 8, 20, 20, 64),      # Sq > Skv, the keys under one tile
    (300, 700, 16, 2, 64),     # GQA, G = 8
    (45, 77, 6, 2, 32),        # bf16 at hd 32 runs the 3xTF32 kernel too
    (37, 300, 8, 2, 128),      # hd 128, G = 4, Sq under one tile
    (200, 77, 12, 1, 192),     # nemotron's hd 192 and G = 12, Sq > Skv
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,H,K,hd", CROSS_CASES)
def test_flash_at_sq_ne_skv_on_card(cuda, dtype, Sq, Skv, H, K, hd):
    """The wgmma (bf16, hd 64) and 3xTF32 (f32; bf16 at hd 32) forwards
    at Sq != Skv without a mask against the plain version, and the rows'
    log-sum-exp (B, H, Sq) they write."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(TORCH_DT[dtype])
               for s in [(2, Sq, H, hd), (2, Skv, K, hd), (2, Skv, K, hd)])
    n = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n + 1 and out.shape == q.shape
    ref = flash_attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])
    lse = torch.empty((2, H, Sq), dtype=torch.float32, device=cuda)
    assert torch.equal(flash_kernel.launch(q, k, v, causal=False, window=None, lse=lse), out)
    want = flash_attention_lse_ref(q, k, causal=False)
    assert (lse - want).abs().max().item() <= LSE_TOL


@pytest.mark.cuda
def test_flash_refuses_a_mask_at_sq_ne_skv_on_card(cuda):
    q = torch.zeros((1, 37, 4, 64), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 150, 4, 64), dtype=torch.bfloat16, device=cuda)
    for causal, window in ((True, None), (False, 16), (True, 16)):
        with pytest.raises(ValueError, match="takes no mask"):
            flash_kernel.launch(q, k, k, causal=causal, window=window)
    with pytest.raises(ValueError, match="takes no mask"):
        ops.flash_attention(q, k, k)        # causal by default


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,H,K,hd", CROSS_CASES)
def test_flash_bwd_at_sq_ne_skv_on_card(cuda, dtype, Sq, Skv, H, K, hd):
    """The backward kernels at Sq != Skv without a mask, held as at Sq ==
    Skv; through the autograd Function, one forward and one backward launch,
    and the same bits twice."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(14)
    q, k, v, do = (torch.randn(s, generator=g, device=cuda).to(TORCH_DT[dtype])
                   for s in [(2, Sq, H, hd), (2, Skv, K, hd), (2, Skv, K, hd), (2, Sq, H, hd)])
    _hold_flash_bwd(q, k, v, do, False, None, dtype)
    fwd, bwd = ops.flash_attention.launches, ops.flash_attention.bwd_launches
    runs = []
    for _ in range(2):
        leaves_ = [t.detach().requires_grad_() for t in (q, k, v)]
        out = ops.flash_attention(*leaves_, causal=False)
        runs.append(torch.autograd.grad(out, leaves_, do))
    assert ops.flash_attention.launches == fwd + 2
    assert ops.flash_attention.bwd_launches == bwd + 2
    for a, b in zip(*runs, strict=True):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", [("float32", 64), ("bfloat16", 32), ("bfloat16", 64)])
def test_flash_c_entry_points_refuse_a_mask_at_sq_ne_skv_on_card(cuda, dtype, hd):
    """Below the wrappers' checks, each C entry point (forward and backward,
    3xTF32 and wgmma) returns cudaErrorInvalidValue (1) for a causal or
    window mask at Sq != Skv, and 0 without one."""
    B, Sq, Skv, H = 1, 37, 150, 4
    q, o, do, dq = (torch.zeros((B, Sq, H, hd), dtype=TORCH_DT[dtype], device=cuda)
                    for _ in range(4))
    k, v, dk, dv = (torch.zeros((B, Skv, H, hd), dtype=TORCH_DT[dtype], device=cuda)
                    for _ in range(4))
    lse, delta = (torch.zeros((B, H, Sq), device=cuda) for _ in range(2))
    wgmma = flash_kernel.route(q.dtype, hd) == "wgmma"
    stream = torch.cuda.current_stream().cuda_stream
    fwd_ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr())
    bwd_ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr())
    dt = () if wgmma else (flash_kernel.DTYPES[q.dtype],)
    # the 3xTF32 forward also takes a scratch pointer and its kv split (none here)
    fwd_split = ((), ()) if wgmma else ((None,), (1, 0))

    def call(fn, ptrs, split, causal, window):
        return fn(*ptrs, *split[0], *dt, B, Sq, Skv, H, H, hd, causal, window, *split[1],
                  hd ** -0.5, stream)

    fns = ((flash_kernel._wgmma_fn() if wgmma else flash_kernel._fn(), fwd_ptrs, fwd_split),
           (flash_kernel._bwd_wgmma_fn() if wgmma else flash_kernel._bwd_fn(), bwd_ptrs,
            ((), ())))
    for fn, ptrs, split in fns:
        for causal, window in ((1, -1), (0, 16), (1, 16)):
            assert call(fn, ptrs, split, causal, window) == 1
        assert call(fn, ptrs, split, 0, -1) == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_over_whisper_cross_cache_on_card(cuda, dtype):
    """Cross decode: one token per sequence against all 1500 frames (G = 1,
    ragged against the kernel's tiles)."""
    g = torch.Generator(device=cuda).manual_seed(12)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(TORCH_DT[dtype])
               for s in [(2, 20, 64), (2, 1500, 20, 64), (2, 1500, 20, 64)])
    lens = torch.full((2,), 1500, dtype=torch.int32, device=cuda)
    out = ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    ref = decode_attention_ref(q.float(), k.float(), v.float(), lens)
    torch.testing.assert_close(out.float(), ref, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
def test_whisper_on_card_equals_cpu(cuda):
    """Reduced whisper (f32): the forward and the decode over a filled cross
    cache on the card against the same calls on the CPU, rel 1e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced(get_config("whisper_large_v3")), enc_frames=75)
    params = M.init_model(cfg, seed=2, device="cpu")
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=g)
    frames = torch.randn((2, cfg.enc_frames, cfg.d_model), generator=g)

    def run(dev):
        p = map_tree(lambda t: t.to(dev), params)
        full = M.forward(p, cfg, tokens.to(dev), frames.to(dev))
        cache = M.init_cache(cfg, 2, 12, device=dev)
        M.prefill_cross(p, cfg, cache, frames.to(dev))
        steps = [M.decode_step(p, cfg, cache, tokens[:, t].to(dev), t)[0] for t in range(12)]
        return full.cpu(), torch.stack(steps, dim=1).cpu()

    for got, want in zip(run(cuda), run("cpu"), strict=True):
        rel = ((got - want).abs().max() / want.abs().max()).item()
        assert rel <= 1e-5, rel


def _mlstm_inputs(cuda, B, S, H, hd, with_state, seed):
    """The model's scales: q carries hd^-0.5, forget gates near sigmoid(2)."""
    g = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda)

    q, k, v = randn(B, S, H, hd) * hd ** -0.5, randn(B, S, H, hd), randn(B, S, H, hd)
    log_f = torch.nn.functional.logsigmoid(randn(B, S, H) + 2.0)
    i_gate = torch.sigmoid(randn(B, S, H))
    state = (randn(B, H, hd, hd) * 0.1, randn(B, H, hd)) if with_state else None
    return (q, k, v, log_f, i_gate), state, randn


def _hold_elementwise(got, want, tol):
    """|got − want| <= tol·(|want| + rms(want)); returns the worst err/tol."""
    want = want.double()
    limit = tol * (want.abs() + want.square().mean().sqrt())
    ratio = ((got.double() - want).abs() / limit).max().item()
    assert ratio <= 1.0, ratio
    return ratio


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,chunk,with_state,final_grads", [
    (2, 512, 4, 512, 64, False, False),   # xlstm-350m's training shape
    (2, 512, 4, 512, 64, True, True),     # with an initial state and final-state gradients
    (2, 300, 4, 512, 64, True, False),    # ragged
    (1, 65, 4, 512, 64, False, True),     # ragged second chunk of one position
    (2, 256, 4, 64, 64, True, True),      # hd 64
    (2, 200, 4, 32, 64, False, False),    # hd 32 (reduced xlstm), ragged
    (2, 100, 3, 32, 32, True, True),      # chunk 32
    (2, 1, 3, 64, 64, True, True),        # one position
    # the edges of the m16n8k8 tiling: a chunk that is no multiple of 16, ragged
    (2, 77, 4, 512, 40, True, True),
    (2, 77, 3, 64, 40, False, True),
    (2, 130, 4, 32, 64, True, False),     # hd 32 with chunk 64: a 64-wide tile wider than hd
])
def test_mlstm_bwd_kernel_on_card(cuda, B, S, H, hd, chunk, with_state, final_grads):
    _check_mlstm_bwd_on_card(cuda, B, S, H, hd, chunk, with_state, final_grads, cancelling=False)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,chunk,with_state,final_grads", [
    (2, 512, 4, 512, 64, True, True),     # xlstm-350m's training shape
    (2, 77, 4, 512, 40, False, True),     # a chunk that is no multiple of 16, ragged
    (2, 256, 4, 64, 64, True, True),      # hd 64
    (2, 200, 4, 32, 64, True, True),      # hd 32
])
def test_mlstm_bwd_kernel_with_cancelling_gates_on_card(cuda, B, S, H, hd, chunk, with_state,
                                                         final_grads):
    """log f near 0 and i near 1: the terms of the reverse cumulative sum
    that is d log f are largest there, and cancel most."""
    _check_mlstm_bwd_on_card(cuda, B, S, H, hd, chunk, with_state, final_grads, cancelling=True)


def _check_mlstm_bwd_on_card(cuda, B, S, H, hd, chunk, with_state, final_grads, cancelling):
    torch.backends.cuda.matmul.allow_tf32 = False
    inputs, state, randn = _mlstm_inputs(cuda, B, S, H, hd, with_state, seed=14)
    if cancelling:
        q, k, v, _, _ = inputs
        inputs = (q, k, v, torch.nn.functional.logsigmoid(randn(B, S, H) + 8.0),
                  torch.sigmoid(randn(B, S, H) + 6.0))
    c = min(chunk, S)
    y, (C, n), saved = mlstm_kernel.launch(*inputs, chunk=c, state=state, save=True)
    plain_y, _ = mlstm_kernel.launch(*inputs, chunk=c, state=state)
    assert torch.equal(y, plain_y)  # saving leaves the output as it was
    dy = randn(B, S, H, hd)
    dC, dn = (randn(B, H, hd, hd), randn(B, H, hd)) if final_grads else (None, None)
    n_bwd = ops.mlstm_chunk.bwd_launches
    got = ops.mlstm_chunk_bwd(*inputs, y, dy, saved=saved, chunk=c, state=state, dC=dC, dn=dn)
    again = ops.mlstm_chunk_bwd(*inputs, y, dy, saved=saved, chunk=c, state=state, dC=dC, dn=dn)
    torch.cuda.synchronize()
    assert ops.mlstm_chunk.bwd_launches == n_bwd + 2
    names = ("dq", "dk", "dv", "dlog_f", "di", "dC0", "dn0")
    for name, a, b in zip(names, got, again, strict=True):
        assert (a is None) == (state is None) if name in ("dC0", "dn0") else a is not None, name
        assert a is None or torch.equal(a, b), name  # no atomics: the same bits
    as64 = lambda t: None if t is None else t.double()  # noqa: E731
    exact = mlstm_chunk_bwd_ref(*(t.double() for t in inputs), y.double(), dy.double(), chunk=c,
                                state=None if state is None else tuple(map(as64, state)),
                                dC=as64(dC), dn=as64(dn))
    plain = mlstm_chunk_bwd_ref(*inputs, y, dy, chunk=c, state=state, dC=dC, dn=dn)
    worst = {}
    for name, a, e, p in zip(names, got, exact, plain, strict=True):
        if a is None:
            continue
        assert a.dtype == torch.float32 and a.shape == p.shape, name
        worst[name] = _hold_elementwise(a, e, MLSTM_BWD_TOL)
        _hold_elementwise(a, p, MLSTM_BWD_TOL)
    return worst


@pytest.mark.cuda
def test_mlstm_bwd_kernel_adds_its_deep_sums_in_fp32_on_card(cuda):
    """The tensor core truncates the sums it accumulates. Over an hd-512 sum
    (64 k-steps of three products) into one accumulator that cost the
    backward err/tol 0.6-0.7 against float64 on dv with final-state
    gradients at xLSTM's training shape; adding every two k-steps into the
    accumulator by an fp32 add (``mma3_rn2`` in csrc/mlstm_chunk_bwd.cu)
    brings every gradient to 0.10 or below. Held at 0.25, between the two."""
    worst = _check_mlstm_bwd_on_card(cuda, 2, 512, 4, 512, 64, True, True, cancelling=False)
    assert max(worst.values()) <= 0.25, worst


@pytest.mark.cuda
def test_mlstm_kernel_saves_nothing_without_a_graph_on_card(cuda):
    inputs, state, _ = _mlstm_inputs(cuda, 1, 100, 2, 64, True, seed=15)
    x = [t.clone().requires_grad_() for t in inputs]

    def allocations():
        return torch.cuda.memory_stats(cuda)["allocation.all.allocated"]

    with torch.no_grad():
        before = allocations()
        y, _ = ops.mlstm_chunk(*x, state=state)
        assert y.grad_fn is None
        assert allocations() == before + 4  # y, C, n and the scores' workspace
    before = allocations()
    y2, _ = ops.mlstm_chunk(*x, state=state)
    assert allocations() == before + 7  # and the saved C_j, n_j, nrm
    assert torch.equal(y, y2)


@pytest.mark.cuda
def test_mlstm_function_launches_the_backward_on_card(cuda):
    inputs, state, randn = _mlstm_inputs(cuda, 2, 130, 4, 64, True, seed=16)
    fwd, bwd = ops.mlstm_chunk.launches, ops.mlstm_chunk.bwd_launches
    grads = []
    for dev in (cuda, "cpu"):
        x = [t.detach().to(dev).requires_grad_() for t in (*inputs, *state)]
        y, (C, n) = ops.mlstm_chunk(*x[:5], state=(x[5], x[6]))
        assert y.grad_fn is not None
        (y.square().sum() + C.sum()).backward()  # n's gradient stays None
        grads.append([t.grad.cpu() for t in x])
    assert ops.mlstm_chunk.launches == fwd + 1
    assert ops.mlstm_chunk.bwd_launches == bwd + 1
    for a, b in zip(*grads, strict=True):
        _hold_elementwise(a, b, MLSTM_BWD_TOL)


def _small_config():
    return dataclasses.replace(reduced(get_config("smollm_360m")), n_heads=6, n_kv_heads=2)


@pytest.mark.cuda
def test_attention_gradients_reach_the_projections_on_card(cuda):
    cfg = _small_config()
    p_cpu = M.init_model(cfg, seed=3, device="cpu")["blocks"][0]["mixer"]
    p_cpu = map_tree(lambda t: t[0].clone(), p_cpu)
    x = torch.randn((2, 70, cfg.d_model), generator=torch.Generator().manual_seed(4))
    grads = []
    for dev in ("cpu", cuda):
        p = map_tree(lambda t: t.detach().to(dev, copy=True).requires_grad_(), p_cpu)
        L.attention(p, x.to(dev), cfg).square().sum().backward()
        grads.append({n: p[n].grad.cpu() for n in ("wq", "wk", "wv", "wo")})
    for name in ("wq", "wk", "wv", "wo"):
        want = grads[0][name]
        assert float(grads[1][name].abs().max()) > 0, name
        torch.testing.assert_close(grads[1][name], want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,remat", [("smollm_360m", False), ("xlstm_350m", False),
                                        ("xlstm_350m", True), ("whisper_large_v3", False),
                                        ("whisper_large_v3", True), ("mixtral_8x7b", False),
                                        ("jamba_1_5_large_398b", False)])
def test_train_step_on_card_equals_cpu(cuda, arch, remat):
    torch.backends.cuda.matmul.allow_tf32 = False
    if arch == "smollm_360m":
        cfg = _small_config()
    else:
        cfg = dataclasses.replace(reduced(get_config(arch)), remat=remat)
    step = build_train_step(cfg, AdamWConfig(lr=1e-3, warmup=2))
    p_cpu = M.init_model(cfg, seed=5, device="cpu")
    batch = synthetic_batch(cfg, 2, 100, seed=6, device="cpu")
    states = {"cpu": (p_cpu, adamw_init(p_cpu)),
              "cuda": (map_tree(lambda t: t.to(cuda), p_cpu), None)}
    states["cuda"] = (states["cuda"][0], adamw_init(states["cuda"][0]))
    bwd = ops.flash_attention.bwd_launches + ops.mlstm_chunk.bwd_launches
    for _ in range(2):
        (pc, oc), (pg, og) = states["cpu"], states["cuda"]
        pc, oc, mc = step(pc, oc, batch)
        pg, og, mg = step(pg, og, map_tree(lambda t: t.to(cuda), batch))
        assert abs(mc["loss"].item() - mg["loss"].item()) < 1e-4
        states = {"cpu": (pc, oc), "cuda": (pg, og)}
    n_attn, n_mlstm, _ = _kernel_layers(cfg)
    assert (ops.flash_attention.bwd_launches + ops.mlstm_chunk.bwd_launches
            == bwd + 2 * (n_attn + n_mlstm))
    for a, b in zip(leaves(states["cpu"][0]), leaves(states["cuda"][0]), strict=True):
        torch.testing.assert_close(b.cpu(), a, atol=2e-3, rtol=0)


@pytest.mark.cuda
def test_moe_mlp_on_card_equals_cpu(cuda):
    """The MoE MLP on the card (f32, mixtral's 8 experts top 2, capacity
    factor 1.0 so that queues overflow) against the same call on the CPU:
    the same experts and the same dropped assignments, output rel < 1e-5,
    and two calls on the card give the same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced(get_config("mixtral_8x7b")),
                              moe=get_config("mixtral_8x7b").moe, moe_capacity_factor=1.0)
    p = L.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, 64, cfg.d_model), generator=torch.Generator().manual_seed(1))
    want, route = L.moe_mlp(p, x, cfg), L.moe_route(p["router"], x, cfg)
    pg, xg = map_tree(lambda t: t.to(cuda), p), x.to(cuda)
    got, got_route = L.moe_mlp(pg, xg, cfg), L.moe_route(pg["router"], xg, cfg)
    assert bool((~route.keep).any())
    assert torch.equal(got_route.expert.cpu(), route.expert)
    assert torch.equal(got_route.keep.cpu(), route.keep)
    rel = ((got.cpu() - want).abs().max() / want.abs().max()).item()
    assert rel < 1e-5, rel
    assert torch.equal(got, L.moe_mlp(pg, xg, cfg))


def _mamba_case(S, seed=0):
    """Reduced jamba at d_model 1024 (d_inner 2048, the published N = 16) in
    f32: mixer params, an input (2, S, 1024) and a non-zero state."""
    cfg = dataclasses.replace(reduced(get_config("jamba_1_5_large_398b")), d_model=1024,
                              ssm_state_dim=16)
    gen = torch.Generator().manual_seed(seed)
    p = ssm.init_mamba(gen, cfg)
    x = torch.randn((2, S, cfg.d_model), generator=gen)
    state = (torch.randn((2, cfg.ssm_conv_width - 1, cfg.d_inner), generator=gen),
             torch.randn((2, cfg.d_inner, cfg.ssm_state_dim), generator=gen) * 0.5)
    return cfg, p, x, state


def _rel(got, want):
    return ((got.cpu().double() - want.double()).abs().max() / want.double().abs().max()).item()


@pytest.mark.cuda
def test_mamba_on_card_equals_cpu(cuda):
    """The mamba mixer (plain PyTorch: conv, projections, the chunked
    doubling scan) at S=512, two chunks, from a non-zero state: output and
    both returned states on the card within rel 1e-5 of the CPU's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, p, x, state = _mamba_case(512)
    want_y, (want_conv, want_ssm) = ssm.mamba(p, x, cfg, state=state)
    got_y, (got_conv, got_ssm) = ssm.mamba(map_tree(lambda t: t.to(cuda), p), x.to(cuda), cfg,
                                           state=tuple(t.to(cuda) for t in state))
    for got, want in ((got_y, want_y), (got_conv, want_conv), (got_ssm, want_ssm)):
        assert got.device.type == cuda.type and got.shape == want.shape
        assert _rel(got, want) <= 1e-5


@pytest.mark.cuda
def test_mamba_decode_on_card_matches_its_forward(cuda):
    """64 single-token calls on the card (the decode step's chunk of 1)
    against one forward over the same 64 tokens there: rel < 1e-3."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, p, x, state = _mamba_case(64, seed=1)
    p, x = map_tree(lambda t: t.to(cuda), p), x.to(cuda)
    state = tuple(t.to(cuda) for t in state)
    full, (conv_f, ssm_f) = ssm.mamba(p, x, cfg, state=state)
    ys = []
    for t in range(64):
        y, state = ssm.mamba(p, x[:, t:t + 1], cfg, state=state)
        ys.append(y)
    assert _rel(torch.cat(ys, dim=1), full.cpu()) < 1e-3
    assert _rel(state[0], conv_f.cpu()) < 1e-3 and _rel(state[1], ssm_f.cpu()) < 1e-3


# The paper's workloads (repro_torch.apps) on the card: library payloads
# (cuBLAS, cuSOLVER), held to their float64 references on the card within
# the limits stated in repro_torch.launch.apps; the engine's price must not
# depend on the device. Sizes of tests/test_apps.py.
APP_SIZES = [("gemm", (256, 64), False), ("tsqr", (1024, 32, 8), False),
             ("rsvd", (512, 8), False), ("rsvd", (512, 8), True),
             ("svc", (4096, 8, 3), False)]


@pytest.mark.cuda
@pytest.mark.parametrize("app,size,ideal", APP_SIZES)
def test_app_on_card_holds_to_its_reference_and_cpu_price(cuda, app, size, ideal):
    from repro_torch.launch import apps as launch_apps

    torch.backends.cuda.matmul.allow_tf32 = False
    before = _all_launches()
    card = launch_apps.run_app(app, size, cuda, ideal_storage=ideal)
    assert _all_launches() == before  # library payloads: no kernel of the port
    assert card["check"]["ok"], card
    cpu = launch_apps.run_app(app, size, "cpu", ideal_storage=ideal)
    assert card["charged_ms"] == cpu["charged_ms"]
    assert card["kv_stats"] == cpu["kv_stats"]


@pytest.mark.cuda
def test_app_blocks_redrawn_on_card_equal_the_first_draw(cuda):
    from repro_torch.apps.device import normal_block

    a = normal_block(4, 3, 0, (4096, 512), cuda)
    b = normal_block(4, 3, 0, (4096, 512), cuda)
    assert torch.equal(a, b)
    assert not torch.equal(a, normal_block(4, 4, 0, (4096, 512), cuda))


@pytest.mark.cuda
def test_ideal_storage_on_card_same_values_fewer_bytes(cuda):
    from repro_torch.launch import apps as launch_apps

    normal = launch_apps.run_app("rsvd", (2048, 8), cuda)
    ideal = launch_apps.run_app("rsvd", (2048, 8), cuda, ideal_storage=True)
    assert normal["check"]["ok"] and ideal["check"]["ok"]
    assert ideal["check"]["singular_values"] == normal["check"]["singular_values"]
    assert ideal["bytes_written"] < normal["bytes_written"] / 2


@pytest.mark.cuda
def test_orchestrator_on_card_reports_as_on_cpu(cuda):
    import dataclasses as dc

    from repro_torch.apps.device import on_device
    from repro_torch.core import JobOrchestrator, OrchestratorConfig, WorkloadConfig

    reports = []
    for dev in (cuda, "cpu"):
        with on_device(dev):
            cfg = OrchestratorConfig(workload=WorkloadConfig(n_jobs=12, seed=0))
            reports.append(dc.asdict(JobOrchestrator(cfg).run()))
    assert reports[0]["completed"] == 12 and reports[0]["failed"] == 0
    assert reports[0] == reports[1]


# ---------------------------------------------------------------------------
# The kernel ops' fake implementations (a dry run's trace) against the kernels
# ---------------------------------------------------------------------------

def _fake_and_real(op, args):
    """(real outputs, fake outputs) of ``op`` on ``args`` and on fake CUDA
    copies of them, and the launches the fake call added (must be none)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    real = op(*args)
    before = _all_launches()
    mode = FakeTensorMode()
    fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
    with mode:
        fake = op(*fake_args)
    return real, fake, _all_launches() == before


def _all_launches():
    """Every kernel op's launch counter, by name (a backward's ``_bwd``)."""
    counters = {"flash_attention": ops.flash_attention, "decode_attention": ops.decode_attention,
                "mlstm_chunk": ops.mlstm_chunk, "adamw": ops.adamw_update,
                "moe_dispatch": ops.moe_dispatch, "moe_combine": ops.moe_combine}
    out = {name: op.launches for name, op in counters.items()}
    out.update({f"{name}_bwd": op.bwd_launches for name, op in counters.items()
                if hasattr(op, "bwd_launches")})
    return out


def _launched(before):
    """The launches since ``before`` (``_all_launches()``), those not zero."""
    return {k: n - before[k] for k, n in _all_launches().items() if n != before[k]}


def _flops(op, args):
    """The operations ``FlopCounterMode`` counts for one call of ``op``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        op(*args)
    return fc.get_total_flops()


def _layout(out):
    return [(tuple(t.shape), t.dtype, t.stride(), t.device.type)
            for t in torch.utils._pytree.tree_leaves(out)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_kernels_match_the_kernels_on_card(cuda, dtype):
    K = torch.ops.repro_torch
    dt = TORCH_DT[dtype]
    g = torch.Generator(device=cuda).manual_seed(24)
    q = torch.randn((2, 100, 6, 64), generator=g, device=cuda).to(dt)
    k, v = (torch.randn((2, 100, 2, 64), generator=g, device=cuda).to(dt) for _ in range(2))
    # the FLOP formulas (the dry run's count) are the kernel check's bound operations:
    # attention 4·hd a visible pair and head, its backward 10·hd; the mLSTM 4·hd a
    # causal pair of a chunk and 4·hd² a position, its backward 10·hd, 8·hd² and 2·hd²
    # a (b, h, chunk)
    pairs, chunk_pairs = sum(min(t + 1, 32) for t in range(100)), 64 * 65 // 2 + 36 * 37 // 2
    n = ops.flash_attention.launches
    args = [q, k, v, True, 32, True]
    real, fake, quiet = _fake_and_real(K.flash_attention_fwd, args)
    assert ops.flash_attention.launches == n + 1 and quiet
    assert _layout(fake) == _layout(real)
    assert _flops(K.flash_attention_fwd, args) == 4 * 2 * 6 * 64 * pairs
    out, (lse,) = real
    args = [q, k, v, out, q, lse, True, 32]
    real, fake, quiet = _fake_and_real(K.flash_attention_bwd, args)
    assert quiet and _layout(fake) == _layout(real)
    assert _flops(K.flash_attention_bwd, args) == 10 * 2 * 6 * 64 * pairs
    lens = torch.tensor([1, 100], dtype=torch.int32, device=cuda)
    for with_lse in (False, True):
        args = [q[:, 0].contiguous(), k, v, lens, with_lse]
        real, fake, quiet = _fake_and_real(K.decode_attention, args)
        assert quiet and _layout(fake) == _layout(real)
        assert _flops(K.decode_attention, args) == 4 * 6 * 64 * (1 + 100)
    x = torch.randn((2, 100, 4, 64), generator=g, device=cuda)
    gate = torch.sigmoid(torch.randn((2, 100, 4), generator=g, device=cuda))
    args = [x, x, x, gate.log(), gate, None, None, 64, True]
    real, fake, quiet = _fake_and_real(K.mlstm_chunk_fwd, args)
    assert quiet and _layout(fake) == _layout(real)
    assert _flops(K.mlstm_chunk_fwd, args) == 2 * 4 * (4 * 64 * chunk_pairs + 4 * 64 * 64 * 100)
    y, _, _, saved = real
    args = [x, x, x, gate.log(), gate, y, y, *saved, None, None, 64, False]
    real, fake, quiet = _fake_and_real(K.mlstm_chunk_bwd, args)
    assert quiet and _layout(fake) == _layout(real)
    assert _flops(K.mlstm_chunk_bwd, args) == 2 * 4 * (
        10 * 64 * chunk_pairs + 8 * 64 * 64 * 100 + 2 * 64 * 64 * 2)
    # AdamW's: the per-shard sum, the finalize, the update (p and g in this dtype)
    p = torch.randn((3, 37), generator=g, device=cuda).to(dt)
    m = torch.randn((3, 37), generator=g, device=cuda)
    count, lr_scale = torch.tensor(1, dtype=torch.int32, device=cuda), torch.ones((), device=cuda)
    real, fake, quiet = _fake_and_real(K.adamw_leaf_sumsq, [p, True])
    assert quiet and _layout(fake) == _layout(real)
    partials = torch.rand(2 * adamw_kernel.SLOTS, device=cuda)
    real, fake, quiet = _fake_and_real(K.adamw_finalize, [partials, 2, count, lr_scale, 1e-3,
                                                          0.9, 0.95, 1.0])
    assert quiet and _layout(fake) == _layout(real)
    real, fake, quiet = _fake_and_real(K.adamw_update, [p, p, m, m.abs(), real[1], False, True,
                                                        0.9, 0.95, 1e-8, 0.1])
    assert quiet and _layout(fake) == _layout(real)
    # the MoE dispatch and combine, and their backwards
    x, slot_row, row_slot, w = _moe_inputs(cuda, dt, 1, 40, 4, 2, 12, 64, seed=25)
    ye = torch.randn((row_slot.numel(), 64), generator=g, device=cuda).to(dt)
    for op, args in ((K.moe_dispatch, [x, row_slot, 2]), (K.moe_dispatch_bwd, [ye, slot_row]),
                     (K.moe_combine, [ye, w, slot_row]),
                     (K.moe_combine_bwd, [ye, w, x.float(), slot_row, row_slot])):
        real, fake, quiet = _fake_and_real(op, args)
        assert quiet and _layout(fake) == _layout(real)


@pytest.mark.cuda
def test_cuda_tensors_still_launch_through_the_ops_on_card(cuda):
    q = torch.randn((1, 64, 2, 64), device=cuda, dtype=torch.bfloat16)
    n = ops.flash_attention.launches
    ops.flash_attention(q, q, q)
    assert ops.flash_attention.launches == n + 1
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q[..., :48].contiguous(), q[..., :48].contiguous(),
                            q[..., :48].contiguous())
    assert ops.flash_attention.launches == n + 1


def _adamw_inputs(dev, p_dtype, g_dtype, seed=0):
    """(params, grads, state) whose leaves are a 37 x 129 matrix, a 3 x 1536 x
    2048 stack, a 1-d leaf and a 5 x 33 view one element into its storage."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = [((37, 129), 0), ((3, 1536, 2048), 0), ((7,), 0), ((5, 33), 1)]

    def draw(dtype, scale, positive=False):
        out = {}
        for i, (shape, offset) in enumerate(shapes):
            n = torch.Size(shape).numel()
            flat = torch.randn(n + offset, generator=gen, device=dev) * scale
            out[f"l{i}"] = (flat.abs() if positive else flat).to(dtype)[offset:].view(shape)
        return out

    params, grads = draw(p_dtype, 1.0), draw(g_dtype, 0.3)
    state = {"mu": draw(torch.float32, 0.05), "nu": draw(torch.float32, 0.01, positive=True),
             "count": torch.tensor(4, dtype=torch.int32, device=dev)}
    return params, grads, state


def _ulp_close(got, want, ulps):
    """|got - want| within ``ulps`` units in the last place of want's type."""
    rel = ulps * torch.finfo(want.dtype).eps
    torch.testing.assert_close(got.float(), want.float(), rtol=rel, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("p_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compress", [None, "bf16"])
@pytest.mark.parametrize("clip_norm", [0.5, 1e4])  # the clip scaling, and not
def test_adamw_kernel_matches_plain_on_card(cuda, p_dtype, g_dtype, compress, clip_norm):
    from repro_torch.kernels.ref import adamw_update_ref
    from repro_torch.optim import adamw_update

    params, grads, state = _adamw_inputs(cuda, TORCH_DT[p_dtype], TORCH_DT[g_dtype])
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.1, clip_norm=clip_norm, grad_compress=compress)
    lr_scale = torch.tensor(0.7, device=cuda)
    ops.adamw_update.launches = 0
    got = adamw_update(grads, state, params, cfg, lr_scale)
    want = adamw_update_ref(grads, state, params, cfg, lr_scale)
    assert ops.adamw_update.launches == 2 * 4 + 1
    torch.testing.assert_close(got[2]["grad_norm"], want[2]["grad_norm"], rtol=1e-6, atol=0)
    assert bool(want[2]["grad_norm"] > clip_norm) == (clip_norm == 0.5)
    assert torch.equal(got[1]["count"], want[1]["count"])
    for key in params:
        p_got, p_want = got[0][key], want[0][key]
        assert p_got.dtype == p_want.dtype and p_got.shape == p_want.shape
        _ulp_close(p_got, p_want, 1 if p_got.dtype == torch.bfloat16 else ADAMW_F32_ULPS)
        for m in ("mu", "nu"):
            _ulp_close(got[1][m][key], want[1][m][key], ADAMW_F32_ULPS)


@pytest.mark.cuda
def test_adamw_kernel_is_pure_repeatable_and_sync_free_on_card(cuda):
    from repro_torch.optim import adamw_update

    params, grads, state = _adamw_inputs(cuda, torch.bfloat16, torch.bfloat16, seed=1)
    cfg = AdamWConfig(clip_norm=0.5, grad_compress="bf16")
    before = [t.clone() for t in leaves((params, grads, state))]
    lr_scale = torch.tensor(0.3, device=cuda)
    ops.adamw_update.launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = adamw_update(grads, state, params, cfg, lr_scale)
        second = adamw_update(grads, state, params, cfg, lr_scale)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ops.adamw_update.launches == 2 * (2 * 4 + 1)
    assert all(torch.equal(a, b) for a, b in zip(leaves(first), leaves(second), strict=True))
    assert all(torch.equal(a, b) for a, b in zip(leaves((params, grads, state)), before,
                                                  strict=True))


@pytest.mark.cuda
@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
def test_adamw_shard_sums_give_the_fused_norm_on_card(cuda, g_dtype):
    """The sharded route on a mesh of one device: each leaf's own sum
    (``adamw_leaf_sumsq``), added in fp32 in leaf order and finalized as
    one slot, gives the unsharded route's norm and coefficients to the bit."""
    K = torch.ops.repro_torch
    _, grads, state = _adamw_inputs(cuda, torch.bfloat16, TORCH_DT[g_dtype], seed=2)
    gs, count = leaves(grads), state["count"]
    lr_scale = torch.tensor(0.9, device=cuda)
    fin = (0.1, 0.9, 0.95, 0.5)  # lr, b1, b2, clip
    partials = torch.empty(len(gs) * adamw_kernel.SLOTS, device=cuda)
    for i, g in enumerate(gs):
        K.adamw_sumsq(g, True, partials, i)
    fused = K.adamw_finalize(partials, len(gs), count, lr_scale, *fin)
    total = sum(K.adamw_leaf_sumsq(g, True) for g in gs)
    sharded = K.adamw_finalize(total.reshape(1), 1, count, lr_scale, *fin)
    assert all(torch.equal(a, b) for a, b in zip(fused, sharded, strict=True))


# ---------------------------------------------------------------------------
# The MoE dispatch and combine (csrc/moe_dispatch.cu) against the plain gathers
# ---------------------------------------------------------------------------

def _moe_inputs(dev, dt, G, g, E, k, cap, d, seed, held=None, skew=False):
    """(x (G·g, d), slot_row, row_slot, w (G·g, k) fp32) of a route over G
    groups of g tokens drawn from random logits (``skew``: every token picks
    expert 0, then 1), its weights rounded to ``dt`` as the layer rounds
    them, the maps of the experts ``held`` = (first, E_l) or all."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn((G, g, E), generator=gen, device=dev)
    if skew:
        logits[..., 0] += 100.0
        logits[..., 1] += 50.0
    top, expert = torch.sort(logits, dim=-1, descending=True, stable=True)
    route = L._queued(expert[..., :k], torch.softmax(top[..., :k], dim=-1), E, cap)
    first, E_l = held or (0, E)
    slot_row, row_slot, _, weights = L.moe_maps(route, E, E_l, first)
    x = torch.randn((G * g, d), generator=gen, device=dev).to(dt)
    return x, slot_row, row_slot, weights.to(dt).float().reshape(G * g, k)


MOE_CASES = {
    # G, g, E, k, cap, d, dtype, held, skew
    "mixtral_train": (4, 512, 8, 2, 160, 4096, "bfloat16", None, False),
    "deepseek_decode": (256, 1, 256, 8, 1, 7168, "bfloat16", (8, 8), False),
    "one_expert_cap1": (2, 64, 8, 2, 1, 96, "bfloat16", None, True),
    "held_slice_f32": (2, 48, 8, 2, 16, 64, "float32", (2, 4), False),
    "k8_f32": (4, 32, 16, 8, 12, 40, "float32", None, False),
}


def _moe_grads(dispatch, combine, x, ye, w, slot_row, row_slot, dxe, dout):
    """(xe, out, dx, dye, dw): the dispatch of x and the combine of ye, and
    the gradients against dxe and dout, through ``dispatch`` and ``combine``
    (the ops, or the plain gathers under autograd)."""
    xg, yg, wg = (t.detach().clone().requires_grad_() for t in (x, ye, w))
    xe, out = dispatch(xg, row_slot, slot_row), combine(yg, wg, row_slot, slot_row)
    return (xe, out, *torch.autograd.grad((xe, out), (xg, yg, wg), (dxe, dout)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_kernels_match_the_plain_gathers_on_card(cuda, case):
    """The four kernels against the plain gathers on the same CUDA tensors:
    the dispatch and the combine equal to the bit at every k (the combine
    adds in slot order in fp32 with no FMA, as the plain loop); dye equal to
    the bit; dx equal to the bit to the token's kept rows added in fp32 in
    slot order and rounded once, and to the plain version's at k <= 2
    (index_put_ adds a token's rows in row order: two addends from 0
    commute), and at k = 8 within k·eps of the type times the sum of the
    rows' magnitudes of the plain version's (its ``index_put_`` reads and
    writes the output row in the type once a duplicate, so it rounds each of
    up to k - 1 partial sums); dw of a kept assignment within the
    bound of an fp32 sum of d terms taken in another order, 2·d·2^-24 times
    the sum of the terms' magnitudes, and 0 for a dropped one (the plain
    version's is the row-0 product, which the route's weight 0 cancels).
    Each call counted once; two calls give the same bits."""
    G, g, E, k, cap, d, dtype, held, skew = MOE_CASES[case]
    dt = TORCH_DT[dtype]
    x, slot_row, row_slot, w = _moe_inputs(cuda, dt, G, g, E, k, cap, d, seed=31, held=held,
                                           skew=skew)
    gen = torch.Generator(device=cuda).manual_seed(32)
    R, T = row_slot.numel(), x.shape[0]
    ye, dxe = (torch.randn((R, d), generator=gen, device=cuda).to(dt) for _ in range(2))
    dout = torch.randn((T, d), generator=gen, device=cuda)
    kept = slot_row >= 0
    assert bool(kept.any()) and (case != "one_expert_cap1" or float(kept.float().mean()) < 0.1)
    counters = [(ops.moe_dispatch, "launches"), (ops.moe_dispatch, "bwd_launches"),
                (ops.moe_combine, "launches"), (ops.moe_combine, "bwd_launches")]
    before = [getattr(o, a) for o, a in counters]
    got = _moe_grads(ops.moe_dispatch, ops.moe_combine, x, ye, w, slot_row, row_slot, dxe, dout)
    assert [getattr(o, a) for o, a in counters] == [n + 1 for n in before]
    want = _moe_grads(lambda x_, rs, sr: moe_dispatch_ref(x_, rs, sr.shape[1]),
                      lambda y_, w_, rs, sr: moe_combine_ref(y_, w_, sr),
                      x, ye, w, slot_row, row_slot, dxe, dout)
    xe, out, dx, dye, dw = got
    assert torch.equal(xe, want[0]) and torch.equal(out, want[1]) and torch.equal(dye, want[3])
    rows = torch.where(kept[..., None], dxe[slot_row.clamp(min=0)].float(), 0.0)
    in_slot_order = rows[:, 0]
    for j in range(1, k):
        in_slot_order = in_slot_order + rows[:, j]
    assert torch.equal(dx, in_slot_order.to(dt))
    if k <= 2:
        assert torch.equal(dx, want[2])
    else:  # index_put_ rounds each of up to k - 1 partial sums to the type
        bound = k * torch.finfo(dt).eps * rows.abs().sum(1)
        assert bool(((dx.float() - want[2].float()).abs() <= bound).all())
    terms = (dout[:, None, :] * ye[slot_row.clamp(min=0)].float()).abs().sum(-1)
    bound = 2 * d * 2.0 ** -24 * terms
    assert bool(((dw - want[4]).abs() <= bound)[kept].all())
    assert bool((dw[~kept] == 0).all())
    again = _moe_grads(ops.moe_dispatch, ops.moe_combine, x, ye, w, slot_row, row_slot, dxe,
                       dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again, strict=True))


@pytest.mark.cuda
def test_moe_kernels_refuse_rows_they_cannot_chunk_on_card(cuda):
    """The kernels move rows in 16-byte chunks: a width that is no multiple of
    8, or rows that start off 16 bytes, raise before any launch."""
    x, slot_row, row_slot, w = _moe_inputs(cuda, torch.bfloat16, 1, 16, 4, 2, 8, 64, seed=35)
    n = ops.moe_dispatch.launches
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.moe_dispatch(x[:, :60], row_slot, slot_row)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:].view_as(x)
    shifted.copy_(x)
    with pytest.raises(ValueError, match="16-byte"):
        ops.moe_dispatch(shifted, row_slot, slot_row)
    ye = torch.empty(row_slot.numel() * 64 + 1, dtype=x.dtype, device=cuda)[1:].view(-1, 64)
    with pytest.raises(ValueError, match="16-byte"):
        ops.moe_combine(ye, w, row_slot, slot_row)
    assert ops.moe_dispatch.launches == n


@pytest.mark.cuda
def test_moe_kernels_replay_in_a_cuda_graph_without_syncing_on_card(cuda):
    """DeepSeek-V3's decode shape: the dispatch and the combine launch with
    no host sync, and captured in a CUDA graph replay what the eager calls
    give on new inputs copied into the captured ones."""
    G, g, E, k, cap, d, dtype, held, skew = MOE_CASES["deepseek_decode"]
    dt = TORCH_DT[dtype]
    x, slot_row, row_slot, w = _moe_inputs(cuda, dt, G, g, E, k, cap, d, seed=33, held=held)
    ye = torch.randn((row_slot.numel(), d), device=cuda).to(dt)

    def step():
        return ops.moe_dispatch(x, row_slot, slot_row), ops.moe_combine(ye, w, row_slot,
                                                                         slot_row)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n = ops.moe_dispatch.launches
    with torch.cuda.graph(graph):
        xe_g, out_g = step()
    assert ops.moe_dispatch.launches == n + 1
    x2, slot_row2, row_slot2, w2 = _moe_inputs(cuda, dt, G, g, E, k, cap, d, seed=34, held=held)
    for t, new in ((x, x2), (slot_row, slot_row2), (row_slot, row_slot2), (w, w2)):
        t.copy_(new)
    ye.normal_()
    graph.replay()
    xe, out = step()
    assert torch.equal(xe_g, xe) and torch.equal(out_g, out)
    assert torch.equal(out, moe_combine_ref(ye, w, slot_row))


# ---------------------------------------------------------------------------
# The configurations on the card: decode against forward at full width,
# serving and training through the engine, a dry-run cell run as traced
# ---------------------------------------------------------------------------

def _kernel_layers(cfg):
    """(attention layers, mLSTM layers, MoE layers) of ``cfg``; an
    encoder-decoder's attention layers are the encoder's and the decoder's
    self- and cross-attention."""
    def count(of, kind):
        return sum(of(e) == kind for e in cfg.block_pattern) * cfg.n_repeats

    n_attn = count(cfg.mixer_of, "attn")
    if cfg.enc_dec:
        n_attn = cfg.n_enc_layers + 2 * n_attn
    return n_attn, count(cfg.mixer_of, "mlstm"), count(cfg.mlp_of, "moe")


def _free_card():
    """Collect the reference cycles that hold tensors and give the cached
    blocks back: the next test may fill the card."""
    gc.collect()
    torch.cuda.empty_cache()


# Decode against one forward over the same 64 positions (B=2), at each
# configuration's full width, its depth cut: (arch, dtype, layers or None for
# all, experts or None for all, window or None for the config's, positions,
# weight seed). bf16: within tests/test_torch_bf16.py's LIMIT over the
# positions whose routing agrees in every layer (all positions without MoE),
# with at most FLIP_SHARE of an MoE config's (token, layer) routings flipped
# (mixtral-8x22b held as 8x7b); an MoE config at a drop-free capacity factor
# (E/k). f32: rel < 1e-3 over every position (qwen2's bias and llama3's G = 16
# on the 3xTF32 route; mixtral's window cut to 48 over 96 positions, so that
# the decode cache's ring wraps).
BF16_LIMIT = {"smollm_360m": 5e-2, "xlstm_350m": 0.15, "mixtral_8x7b": 5e-2,
              "mixtral_8x22b": 5e-2, "jamba_1_5_large_398b": 0.18, "whisper_large_v3": 5e-2,
              "nemotron_4_340b": 5e-2, "llama3_405b": 5e-2, "qwen2_72b": 5e-2,
              "chameleon_34b": 5e-2}
FLIP_SHARE = {"mixtral_8x7b": 0.05, "mixtral_8x22b": 0.05, "jamba_1_5_large_398b": 0.05}
F32_LIMIT = 1e-3
JAMBA = "jamba_1_5_large_398b"
DECODE_CASES = {
    "smollm-f32": ("smollm_360m", "float32", None, None, None, 64, 0),
    "smollm-bf16": ("smollm_360m", "bfloat16", None, None, None, 64, 0),
    "xlstm-f32": ("xlstm_350m", "float32", None, None, None, 64, 0),
    **{f"xlstm-bf16-seed{s}": ("xlstm_350m", "bfloat16", None, None, None, 64, s)
       for s in range(3)},
    "nemotron-bf16": ("nemotron_4_340b", "bfloat16", 2, None, None, 64, 0),
    "nemotron-f32": ("nemotron_4_340b", "float32", 1, None, None, 64, 0),
    "llama3-bf16": ("llama3_405b", "bfloat16", 2, None, None, 64, 0),
    "llama3-f32": ("llama3_405b", "float32", 1, None, None, 64, 0),
    "qwen2-bf16": ("qwen2_72b", "bfloat16", 4, None, None, 64, 0),
    "qwen2-f32": ("qwen2_72b", "float32", 1, None, None, 64, 0),
    "chameleon-bf16": ("chameleon_34b", "bfloat16", 4, None, None, 64, 0),
    "mixtral_8x22b-bf16": ("mixtral_8x22b", "bfloat16", 2, None, None, 64, 0),
    "mixtral-bf16": ("mixtral_8x7b", "bfloat16", 4, None, None, 64, 0),
    "mixtral-f32": ("mixtral_8x7b", "float32", 2, None, None, 64, 0),
    "mixtral-f32-ring": ("mixtral_8x7b", "float32", 2, None, 48, 96, 0),
    # one superblock (7 mamba layers, 1 attention, MoE on 4); 8 experts of 16 hold
    # 51.8 GB in bf16, 4 hold 65.0 GB in f32
    "jamba-bf16": (JAMBA, "bfloat16", 8, 8, None, 64, 0),
    "jamba-f32": (JAMBA, "float32", 8, 4, None, 64, 0),
    "whisper-bf16": ("whisper_large_v3", "bfloat16", None, None, None, 64, 0),
    "whisper-f32": ("whisper_large_v3", "float32", None, None, None, 64, 0),
}
# the published widths these cases stand on (arXiv:2401.04088, 2403.19887; whisper-large-v3's
# config.json)
PUBLISHED = {
    "mixtral_8x7b": {"d_model": 4096, "n_heads": 32, "n_kv_heads": 8, "hd": 128,
                     "d_ff": 14336, "vocab": 32000, "n_experts": 8, "top_k": 2,
                     "sliding_window": 4096, "rope_theta": 1e6, "tie_embeddings": False},
    JAMBA: {"d_model": 8192, "d_inner": 16384, "ssm_state_dim": 16, "n_heads": 64,
            "n_kv_heads": 8, "hd": 128, "d_ff": 24576, "vocab": 65536, "n_experts": 16,
            "top_k": 2, "sliding_window": None, "tie_embeddings": False},
    "whisper_large_v3": {"d_model": 1280, "n_heads": 20, "n_kv_heads": 20, "hd": 64,
                         "d_ff": 5120, "activation": "gelu", "vocab": 51866, "n_layers": 32,
                         "n_enc_layers": 32, "enc_frames": 1500, "tie_embeddings": False,
                         "enc_dec": True},
}


# the configurations the bring-up's script drew its decode tokens for after a (1, 512)
# forward batch; the others after a (2, 512) one
ONE_ROW_FORWARD = ("nemotron_4_340b", "llama3_405b", "qwen2_72b", "chameleon_34b",
                   "mixtral_8x22b")


def _phase_tokens(arch, vocab, S):
    """The (2, S) tokens the bring-up's script held this check on (numpy, seed
    0): smollm's and xLSTM's the first S of a (2, 512) draw over smollm's
    vocabulary; the others drawn after their forward's batch (and, for the
    ring check's 96 positions, after the 64 of the decode check)."""
    rng = np.random.default_rng(0)
    if arch in ("smollm_360m", "xlstm_350m"):
        return torch.as_tensor(rng.integers(0, get_config("smollm_360m").vocab, (2, 512))[:, :S])
    rng.integers(0, vocab, (1 if arch in ONE_ROW_FORWARD else 2, 512))
    if S != 64:
        rng.integers(0, vocab, (2, 64))
    return torch.as_tensor(rng.integers(0, vocab, (2, S)))


def _decode_config(arch, dtype, layers, experts, window):
    full = get_config(arch)
    for name, value in PUBLISHED.get(arch, {}).items():
        assert getattr(full.moe if name in ("n_experts", "top_k") else full, name) == value, name
    cfg = dataclasses.replace(full, dtype=dtype, n_layers=layers or full.n_layers)
    if experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=experts))
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    if cfg.moe is not None:  # drop-free: each expert's queue holds a whole group
        cfg = dataclasses.replace(cfg, moe_capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_matches_forward_at_full_width_on_card(cuda, case):
    """Step-by-step decode logits against one forward's at the configuration's
    full width (the width picks the kernels' route and instantiation), weights
    made on the card from a seed; one flash launch per attention layer in the
    forward (whisper: and the encoder's again to fill the cross cache) and one
    decode launch per attention layer and step."""
    from repro_torch.launch.serve import request_frames

    arch, dtype, layers, experts, window, S, seed = DECODE_CASES[case]
    torch.backends.cuda.matmul.allow_tf32 = False
    _free_card()
    cfg = _decode_config(arch, dtype, layers, experts, window)
    params = M.init_model(cfg, seed=seed, device=cuda)
    tokens = _phase_tokens(arch, cfg.vocab, S).to(cuda)
    frames = (torch.from_numpy(request_frames(1, 0, 2, cfg.enc_frames, cfg.d_model)).to(cuda)
              if cfg.enc_dec else None)  # a request's frames, as serving draws them
    before = _all_launches()
    with routes_recorded(L) as routes:
        full = M.forward(params, cfg, tokens, frames)
        cache = M.init_cache(cfg, 2, S, device=cuda)
        if cfg.enc_dec:
            M.prefill_cross(params, cfg, cache, frames)
        steps = []
        for t in range(S):
            logits, cache = M.decode_step(params, cfg, cache, tokens[:, t], t)
            steps.append(logits)
    launches = _launched(before)
    dec = torch.stack(steps, dim=1)
    n_attn, n_mlstm, _ = _kernel_layers(cfg)
    n_enc = cfg.n_enc_layers if cfg.enc_dec else 0
    for name, n in (("flash_attention", n_attn + n_enc), ("decode_attention", S * (n_attn - n_enc)),
                    ("mlstm_chunk", n_mlstm)):
        assert launches.get(name, 0) == n, (name, launches)
    assert not {"flash_attention_bwd", "mlstm_chunk_bwd"} & set(launches), launches
    if dtype == "float32":
        assert _rel(dec, full.cpu()) < F32_LIMIT
        return
    flips = (routing_flips([r.expert.reshape(2, -1, r.expert.shape[-1]) for r in routes], S)
             if routes else torch.zeros((1, 2, S), dtype=torch.bool, device=cuda))
    flipped = flips.any(dim=0)
    err = _rel(torch.where(flipped[..., None], full, dec), full.cpu())
    assert err < BF16_LIMIT[arch], err
    assert flips.float().mean().item() <= FLIP_SHARE.get(arch, 0.0), flips.sum(dim=(1, 2))


# Reduced f32 models served on the card and on the CPU from the same weights:
# smollm at G = 3, xLSTM, mixtral with a window of 8 (the ring wraps), jamba and
# whisper
SERVE_CONFIGS = {
    "smollm_360m": {"n_heads": 6, "n_kv_heads": 2},
    "xlstm_350m": {},
    "mixtral_8x7b": {"sliding_window": 8},
    JAMBA: {},
    "whisper_large_v3": {},
}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(SERVE_CONFIGS))
def test_serving_on_card_gives_the_cpu_tokens(cuda, arch):
    """``launch.serve.serve`` through the engine: the same greedy tokens on
    the card as on the CPU, each in the vocabulary, and one decode launch per
    attention layer (whisper: self and cross) and step of each request."""
    from repro_torch.launch.serve import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced(get_config(arch)), **SERVE_CONFIGS[arch])
    p_cpu = M.init_model(cfg, seed=1, device="cpu")
    kw = dict(requests=2, batch=3, prompt_len=8, gen_len=12, seed=1)
    before = _all_launches()
    on_card = serve(cfg, map_tree(lambda t: t.to(cuda), p_cpu), device=cuda, **kw)
    launches = _launched(before)
    on_cpu = serve(cfg, p_cpu, device="cpu", **kw)
    got, want = (r.results["summary"]["tokens"] for r in (on_card, on_cpu))
    assert len(got) == kw["requests"]
    for a, b in zip(got, want, strict=True):
        assert a.shape == (kw["batch"], kw["gen_len"]) and 0 <= a.min() and a.max() < cfg.vocab
        assert (a == b).all(), (a, b)
    n_attn = _kernel_layers(cfg)[0] - (cfg.n_enc_layers if cfg.enc_dec else 0)
    steps = kw["prompt_len"] + kw["gen_len"] - 1
    assert launches.get("decode_attention", 0) == kw["requests"] * n_attn * steps, launches


# Training through the engine's workflow (``runtime.orchestrator``) on the card,
# at full width, bf16 under ``remat``, its depth cut: (arch, layers, encoder layers,
# B, S, steps, injected failures). The faults' seeds make step tasks fail at their
# first attempt and no task of the DAG at its last (attempt 2), whatever order the
# executors run in: at seed 6 the 8-step DAG's steps 3 and 7, at seed 7 one task of
# the 4-step DAG.
TRAIN_CASES = {
    "smollm_360m": (2, 0, 4, 512, 8, {"task_failure_prob": 0.05, "max_retries": 2, "seed": 6}),
    "xlstm_350m": (2, 0, 2, 512, 4, {"task_failure_prob": 0.05, "max_retries": 2, "seed": 7}),
    "whisper_large_v3": (2, 2, 4, 448, 3, None),
    "mixtral_8x7b": (1, 0, 4, 512, 2, None),
}
TRAIN_PEAK_TOL = 0.05


def _workflow_peak_gib(cfg, steps):
    """The training workflow's peak device memory, reckoned from the config's
    shapes: the engine keeps every step run's state (the parameters and
    AdamW's fp32 moments), so the last of ``steps`` runs starts with ``steps``
    states held and peaks at the end of ``adamw_update``, holding the
    gradients in the parameters' dtype and the new parameters and moments
    (the AdamW kernels hold no temporary of a leaf's size, only the norm's
    partial sums, ``SLOTS`` fp32 a leaf). The loss's activations are freed by
    then."""
    shapes = leaves(M.abstract_params(cfg))
    params_b = sum(t.numel() * t.element_size() for t in shapes)
    state_b = params_b + 8 * sum(t.numel() for t in shapes) + 4   # and the int32 count
    step_b = params_b + state_b + 4 * adamw_kernel.SLOTS * len(shapes)
    return (steps * state_b + step_b) / 2**30


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(TRAIN_CASES))
def test_training_workflow_on_card(cuda, arch):
    """``steps`` AdamW steps on one fixed batch as tasks of the engine: the
    loss finite and falling; the injected failures there when asked for and
    every step task done; per step run each attention and mLSTM layer's
    forward launched twice (the forward and its recomputation) and its
    backward once, each MoE layer's dispatch and combine twice and their
    backwards once, AdamW 2 a leaf and 1 a step; mixtral's peak within
    ``TRAIN_PEAK_TOL`` of ``_workflow_peak_gib``."""
    from repro_torch.core import EngineConfig, FaultConfig
    from repro_torch.runtime.orchestrator import build_training_workflow, run_training_workflow

    layers, enc_layers, B, S, steps, faults = TRAIN_CASES[arch]
    _free_card()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    cfg = dataclasses.replace(get_config(arch), n_layers=layers, n_enc_layers=enc_layers)
    assert cfg.remat and cfg.dtype == "bfloat16"
    params = M.init_model(cfg, seed=0, device=cuda)
    data = synthetic_batch(cfg, B, S, seed=7, device=cuda)
    step = build_train_step(cfg, AdamWConfig(lr=5e-3, weight_decay=0.0, warmup=1))
    runs = []

    def step_fn(state, i):
        p, o, m = step(*state, data)
        runs.append(i)
        return (p, o), {"loss": float(m["loss"])}

    dag, final_key, metric_keys = build_training_workflow(
        n_steps=steps, step_fn=step_fn, init_fn=lambda: (params, adamw_init(params)))
    before = _all_launches()
    res = run_training_workflow(dag, final_key, metric_keys, EngineConfig(
        faults=FaultConfig(**(faults or {})), job_timeout_s=3600.0))
    launches = _launched(before)
    peak_gib = (torch.cuda.max_memory_allocated(cuda) - base) / 2**30
    losses = [res.report.results[k]["loss"] for k in metric_keys]
    assert all(map(math.isfinite, losses)) and losses[-1] < losses[0], losses
    assert int(res.report.results[final_key][1]["count"]) == steps
    assert (res.report.fault_stats["injected_failures"] > 0) == (faults is not None)
    n, (n_attn, n_mlstm, n_moe) = len(runs), _kernel_layers(cfg)
    assert n >= steps
    want = {"flash_attention": 2 * n_attn * n, "flash_attention_bwd": n_attn * n,
            "mlstm_chunk": 2 * n_mlstm * n, "mlstm_chunk_bwd": n_mlstm * n,
            "moe_dispatch": 2 * n_moe * n, "moe_dispatch_bwd": n_moe * n,
            "moe_combine": 2 * n_moe * n, "moe_combine_bwd": n_moe * n,
            "adamw": (2 * len(leaves(params)) + 1) * n}
    assert launches == {k: v for k, v in want.items() if v}, (launches, n)
    if arch == "mixtral_8x7b":
        reckoned = _workflow_peak_gib(cfg, steps)
        assert abs(peak_gib / reckoned - 1) <= TRAIN_PEAK_TOL, (peak_gib, reckoned)


@pytest.mark.cuda
def test_moe_train_step_on_card_is_bitwise_repeatable(cuda):
    """mixtral-8x7b at full width, 1 layer, B=4 S=512, bf16 under ``remat``:
    one train step run twice on one state (the engine's re-run of a step
    task) gives the same parameters, moments and metrics to the bit and
    leaves the state as it was; the recomputation routes every token as the
    forward did (the route has no atomics), at the queue places the capacity
    factor gives."""
    _free_card()
    cfg = dataclasses.replace(get_config("mixtral_8x7b"), n_layers=1)
    assert cfg.remat and cfg.dtype == "bfloat16"
    B, S = 4, 512
    params = M.init_model(cfg, seed=0, device=cuda)
    state = (params, adamw_init(params))
    data = synthetic_batch(cfg, B, S, seed=7, device=cuda)
    kept = [t.cpu() for t in leaves(state)]
    step = build_train_step(cfg, AdamWConfig(lr=5e-3, weight_decay=0.0, warmup=1))
    with routes_recorded(L) as routes:
        first = step(*state, data)
    second = step(*state, data)
    assert all(torch.equal(a, b) for a, b in zip(leaves(first), leaves(second), strict=True))
    assert first[2]["loss"].item() == second[2]["loss"].item()
    del first, second
    assert all(torch.equal(t, k.to(cuda)) for t, k in zip(leaves(state), kept, strict=True))
    # the forward's routes, then the recomputation's, the layers in reverse
    n = cfg.n_layers
    assert len(routes) == 2 * n, len(routes)
    g = min(cfg.moe_group, S)
    cap = max(1, int(cfg.moe.top_k * g * cfg.moe_capacity_factor / cfg.moe.n_experts))
    for a, b in zip(routes[:n], reversed(routes[n:]), strict=True):
        assert a.cap == b.cap == cap
        for name in ("expert", "slot", "keep"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name


# smollm-360m's train cell of the dry run (B=256, S=4096), at 32 microbatches: it fits one
# H100 (16 is the least power of two that does).
DRYRUN_CELL = ("smollm_360m", "train_4k", 32)
# the fake-CUDA trace's bytes and peak against the meta trace's (relative)
META_GAP = 0.01
# the CUDA caching allocator rounds each tensor up to 512 bytes, and hands a
# large tensor a cached block whole when splitting it would leave 1 MB or less
ALLOC_UNSPLIT = 1 << 20
# The measured peak (max_memory_allocated over the step) against the traced
# one. First readings (H100, 700 W): 1.0 exactly for both xLSTM decode cells,
# 1.000001 for this cell at 16 microbatches (77 KB over 75.6 GB). The trace
# counts the same allocations rounded as the allocator rounds them, so it can
# over-count only by a tensor that a real run frees sooner (none seen); it
# leaves out the kernels' scratch (flash backward's row sums, B·H·Sq fp32;
# decode's partials; the mLSTM workspaces) and the cached blocks the
# allocator hands out whole (up to 1 MB over a large tensor's request),
# which a peak can hold: 1 % above covers that.
PEAK_BAND = (0.999, 1.01)


@pytest.mark.cuda
def test_dryrun_cell_runs_on_card_as_traced_and_sharded(cuda):
    """A dry-run cell that fits one H100, run on it. Its trace on fake CUDA
    tensors (the card's route) gives the meta trace's FLOPs and kernel calls,
    bytes and peak within ``META_GAP``. Its arguments allocated on the card
    request the dry run's argument bytes exactly. One step there counts the
    traced FLOPs (``FlopCounterMode``), launches the traced kernel calls, and
    peaks within ``PEAK_BAND`` of the traced peak. The same step on DTensors
    placed by the dry run's rules on the card's world-of-one NCCL 1×1 mesh
    (the kernels through their sharded entries) gives every output to the
    bit, the same launches and no collective. The test destroys its process
    group."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as mesh_lib

    arch, shape, n = DRYRUN_CELL
    cfg, variant = get_config(arch), D.Variant(n_microbatches=n, tag=f"n_microbatches={n}")
    meta = D.trace_cell(cfg, shape, variant)
    traced = D.trace_cell(cfg, shape, variant, device="cuda")
    for key in ("flops", "kernel_calls"):
        assert traced[key] == meta[key], key
    for key in ("bytes_accessed", "peak_bytes"):
        assert abs(traced[key] / meta[key] - 1) <= META_GAP, (key, traced[key], meta[key])
    cell = D.build_cell(cfg, shape, variant)
    mesh = mesh_lib.make_host_mesh("cuda")
    try:
        arg_bytes = D.argument_bytes(cell, mesh)["total"]
        _free_card()
        base = torch.cuda.memory_allocated()
        base_requested = torch.cuda.memory_stats()["requested_bytes.all.current"]
        args = D.materialize(cell, cuda)
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated() - base
        requested = torch.cuda.memory_stats()["requested_bytes.all.current"] - base_requested
        n_tensors = sum(isinstance(t, torch.Tensor) for t in leaves(args))
        assert requested == arg_bytes, (requested, arg_bytes)
        assert 0 <= allocated - requested <= n_tensors * ALLOC_UNSPLIT, (allocated, requested)
        torch.cuda.reset_peak_memory_stats()
        before = _all_launches()
        with D.flop_counter() as fc:
            out = cell.step()(args)
            torch.cuda.synchronize()
        plain_launches = _launched(before)
        peak = torch.cuda.max_memory_allocated() - base
        del out
        assert fc.get_total_flops() == traced["flops"]
        calls = dict(traced["kernel_calls"])
        # AdamW's ops share one counter: its sum of squares and update a leaf, its finalize
        adamw = sum(calls.pop(k, 0) for k in ("adamw_sumsq", "adamw_finalize", "adamw_update"))
        calls = {{"flash_attention_fwd": "flash_attention"}.get(k, k): v for k, v in calls.items()}
        assert plain_launches == {**calls, "adamw": adamw}, (plain_launches, traced["kernel_calls"])
        assert PEAK_BAND[0] <= peak / traced["peak_bytes"] <= PEAK_BAND[1], (
            peak, traced["peak_bytes"])
        # the sharded step's reference: the plain step outside the FLOP counter (a step
        # under the counter gave other bits on an H100)
        _free_card()
        want = [t.cpu() for t in leaves(cell.step()(args))]
        _free_card()
        sargs = D.shard_args(cell, mesh, args)
        before = _all_launches()
        with implicit_replication(), D.CollectiveCounter() as cc:
            out = cell.step(D.placements(cell, mesh))(sargs)
        torch.cuda.synchronize()
        assert _launched(before) == plain_launches, (_launched(before), plain_launches)
        got = [t.to_local() if hasattr(t, "to_local") else t for t in leaves(out)]
        assert len(got) == len(want)
        assert all(torch.equal(a, b.cpu()) for a, b in zip(want, got, strict=True))
        assert cc.tally.record()["total"] == 0, cc.tally.record()
    finally:
        dist.destroy_process_group()

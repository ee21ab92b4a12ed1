"""The port's CUDA kernels against their plain versions, on the card.

Needs a CUDA device and skips without one (the kernels have no CPU mode).
Imports neither JAX nor ``repro``, so it runs where only the port is
installed; ``tests/conftest.py`` imports JAX, so on such a machine run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 2e-5, bf16 2e-2 (tests/test_kernels.py), against the
plain version computed in f32 from the same inputs.
"""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import decode_attention_ref, flash_attention_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,K,hd", [(100, 15, 5, 64), (512, 8, 2, 32),
                                      (64, 16, 1, 128), (77, 4, 4, 16)])
def test_decode_kernel_on_card(cuda, dtype, S, H, K, hd):
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(TORCH_DT[dtype])
               for s in [(4, H, hd), (4, S, K, hd), (4, S, K, hd)])
    lens = torch.tensor([1, S // 3, S, S + 9], dtype=torch.int32, device=cuda)
    out = ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    ref = decode_attention_ref(q.float(), k.float(), v.float(), lens)
    torch.testing.assert_close(out.float(), ref, atol=TOL[dtype], rtol=TOL[dtype])

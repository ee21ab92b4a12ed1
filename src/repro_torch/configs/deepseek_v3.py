"""DeepSeek-V3 [arXiv:2412.19437; huggingface.co/deepseek-ai/DeepSeek-V3 config.json].

61L d_model=7168 128H vocab=129280. Multi-head latent attention in every
layer: q through rank 1536, keys and values through one 512-wide latent plus
a 64-wide rotary key shared by the heads; per head 128 + 64 in q·k and 128
in v; YaRN (factor 40 over 4096 positions). The first 3 layers are dense
(d_ff=18432); the other 58 are DeepSeekMoE: 256 routed experts of width 2048,
top 8 by sigmoid score plus a correction bias among the best 4 of 8 groups,
weights normalised and scaled by 2.5, and one shared expert. The block
pattern spells out all 61 layers as one repeat. The multi-token prediction
module is not modelled (greedy serving does not run it).
"""
from repro_torch.models.deepseek_config import DeepSeekMoEConfig, MLAConfig, YarnRope

N_LAYERS, FIRST_DENSE = 61, 3

CONFIG = MLAConfig(
    name="deepseek-v3",
    family="moe",
    n_layers=N_LAYERS,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,
    vocab=129280,
    block_pattern=("mla+dense",) * FIRST_DENSE + ("mla+moe",) * (N_LAYERS - FIRST_DENSE),
    moe=DeepSeekMoEConfig(n_experts=256, top_k=8, n_groups=8, topk_groups=4,
                          routed_scale=2.5, n_shared=1, d_expert=2048),
    activation="swiglu",
    rope_theta=10000.0,
    norm_eps=1e-6,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    yarn=YarnRope(factor=40.0, original_max_position=4096, beta_fast=32.0, beta_slow=1.0,
                  mscale=1.0, mscale_all_dim=1.0),
)

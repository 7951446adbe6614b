"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, no dense MLP.
94L d_model=4096 64H (GQA kv=4) expert_ff=1536 vocab=151936
[hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    arch_id="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    d_ff=0,                      # all layers MoE, no dense MLP
    vocab_size=151_936, head_dim=128,
    num_experts=128, moe_top_k=8, expert_ff=1536,
    moe_every=1)

SMOKE = ModelConfig(
    arch_id="qwen3-moe-235b-a22b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=0, vocab_size=256, head_dim=16,
    num_experts=8, moe_top_k=4, expert_ff=96,
    moe_every=1)

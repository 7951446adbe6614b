"""arctic-480b [moe] — 128 experts top-2 + parallel dense residual MLP.
35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2
[hf:Snowflake/snowflake-arctic-base; hf]

Every layer: attention, then (dense MLP ff=4864) ∥ (MoE 128e top-2,
expert ff=4864) in parallel from the same normed input (dense_residual).
56 heads padded to 64 for the 16-way model axis.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    arch_id="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32_000, head_dim=128,
    num_experts=128, moe_top_k=2, expert_ff=4864,
    moe_every=1, dense_residual=True)

SMOKE = ModelConfig(
    arch_id="arctic-480b-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=96, vocab_size=256, head_dim=16,
    num_experts=8, moe_top_k=2, expert_ff=96,
    moe_every=1, dense_residual=True)

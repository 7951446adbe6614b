"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE.
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2
[arXiv:2403.19887; hf]

Layer pattern (period 8): attention at i % 8 == 4, Mamba2 elsewhere;
MoE replaces the MLP every other layer (odd indices).  SSD heads:
d_inner=8192, headdim=64 -> 128 heads (16-divisible, no padding).
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    arch_id="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14_336, vocab_size=65_536, head_dim=128,
    num_experts=16, moe_top_k=2, expert_ff=14_336,
    moe_every=2, moe_offset=1,
    ssm_state=128, ssm_headdim=64, ssm_expand=2,
    attn_every=8, attn_offset=4)

SMOKE = ModelConfig(
    arch_id="jamba-v0.1-52b-smoke", family="hybrid",
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    num_experts=4, moe_top_k=2, expert_ff=128,
    moe_every=2, moe_offset=1,
    ssm_state=16, ssm_headdim=16, ssm_expand=2,
    attn_every=8, attn_offset=4)

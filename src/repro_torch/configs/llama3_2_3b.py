"""llama3.2-3b [dense] — small llama3.
28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256
[hf:meta-llama/Llama-3.2-1B; unverified]
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    arch_id="llama3.2-3b", family="dense",
    num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=128_256, head_dim=128,
    rope_theta=500_000.0)

SMOKE = ModelConfig(
    arch_id="llama3.2-3b-smoke", family="dense",
    num_layers=2, d_model=48, num_heads=3, num_kv_heads=1,
    d_ff=128, vocab_size=256, head_dim=16, rope_theta=500_000.0)

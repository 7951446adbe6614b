"""qwen1.5-110b [dense] — QKV bias.
80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064
[hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    arch_id="qwen1.5-110b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=49_152, vocab_size=152_064, head_dim=128,
    qkv_bias=True)

SMOKE = ModelConfig(
    arch_id="qwen1.5-110b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=256, head_dim=16, qkv_bias=True)

"""deepseek-coder-33b [dense] — llama-arch.
62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256  [arXiv:2401.14196; hf]

56 query heads are not divisible by the 16-way model axis: padded to 64
at param-build time (zeroed, exact outputs).
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    arch_id="deepseek-coder-33b", family="dense",
    num_layers=62, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=19_200, vocab_size=32_256, head_dim=128)

SMOKE = ModelConfig(
    arch_id="deepseek-coder-33b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=7, num_kv_heads=1,  # odd heads kept
    d_ff=192, vocab_size=256, head_dim=16)

"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.
24L d_model=768 d_ff=0 vocab=50280, ssm_state=128  [arXiv:2405.21060; unverified]

No attention, no MLP: each layer is a single Mamba2 block.  SSD heads:
d_inner=1536, headdim=64 -> 24 heads (padded to 32 on a 16-way model axis).
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    arch_id="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50_280, head_dim=0,
    ssm_state=128, ssm_headdim=64, ssm_expand=2,
    tie_embeddings=True)

SMOKE = ModelConfig(
    arch_id="mamba2-130m-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=256, head_dim=0,
    ssm_state=16, ssm_headdim=16, ssm_expand=2,
    tie_embeddings=True)

"""internvl2-26b [vlm] — InternViT + InternLM2 backbone.
48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553  [arXiv:2404.16821; hf]

Backbone-only per the brief: the InternViT frontend is a stub —
``input_specs()`` supplies precomputed patch embeddings (B, 256, d_model)
prepended to the token embeddings.  Decode is text-only with a KV cache.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    arch_id="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92_553, head_dim=128,
    frontend="vision", num_prefix=256)

SMOKE = ModelConfig(
    arch_id="internvl2-26b-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    frontend="vision", num_prefix=8)

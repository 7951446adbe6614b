"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal.
24L d_model=1024 16H (kv=16 => MHA) d_ff=8192 vocab=256206
[arXiv:2308.11596; hf]

Backbone-only: the speech frontend is a stub — ``input_specs()`` supplies
precomputed frame embeddings (B, S, d_model) as encoder input.  Decode =
text decoder with self-KV cache + cached encoder cross-K/V.
"""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    arch_id="seamless-m4t-large-v2", family="encdec",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=256_206, head_dim=64,
    encoder_layers=24, frontend="audio")

SMOKE = ModelConfig(
    arch_id="seamless-m4t-large-v2-smoke", family="encdec",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16,
    encoder_layers=2, frontend="audio")

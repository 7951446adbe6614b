"""The port's transformer building blocks (repro_torch.models.layers) against
the JAX reference (repro.models.layers) on the same seeded numpy inputs:
RMSNorm, RoPE, chunked GQA attention, the SwiGLU MLP and the cache
write."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_parity import ref_jit, to_numpy, to_torch
from repro.models import layers as ref_layers
from repro_torch.models import layers


def _normal(seed, shape, dtype="float32", scale=1.0):
    x = (scale * np.random.default_rng(seed).standard_normal(shape))
    return jnp.asarray(x.astype(np.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    x = _normal(0, (3, 5, 64), dtype, 3.0)
    scale = _normal(1, (64,), dtype)
    ref = ref_jit(lambda x, s: ref_layers.rms_norm(x, s, 1e-6), x, scale)(
        x, scale)
    got = layers.rms_norm(to_torch(x), to_torch(scale), 1e-6)
    assert got.dtype == to_torch(x).dtype
    np.testing.assert_allclose(to_numpy(got), np.asarray(ref, np.float32),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope_matches_reference_to_position_4096(theta):
    """Half-split rotation with f32 angles: XLA's and torch's f32 cos/sin
    differ by up to ~6e-5 at angles near 4096 (a few ulps of the angle),
    so the bar is 2e-4 of |x| there; below position 64 they agree to
    1e-6."""
    pos = np.concatenate([np.arange(64), np.arange(4032, 4097)])
    x = _normal(2, (2, pos.size, 3, 32))
    ref = np.asarray(ref_layers.apply_rope(x, jnp.asarray(pos)[None], theta))
    got = to_numpy(layers.apply_rope(to_torch(x), torch.from_numpy(pos)[None],
                                     theta))
    np.testing.assert_allclose(got[:, :64], ref[:, :64], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4 * 4)
    freqs = np.asarray(ref_layers.rope_freqs(32, theta))
    np.testing.assert_array_equal(to_numpy(layers.rope_freqs(32, theta)),
                                  freqs)


def _attn_case(seed, b, sq, t, h, kvh, hd, dtype="float32"):
    return (_normal(seed, (b, sq, h, hd), dtype),
            _normal(seed + 1, (b, t, kvh, hd), dtype),
            _normal(seed + 2, (b, t, kvh, hd), dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,valid,start", [(True, None, 0),
                                                (True, 40, 8),
                                                (False, None, 0),
                                                (False, 50, 0)])
def test_attention_matches_reference(dtype, causal, valid, start):
    """GQA (6 query heads on 2 KV heads), causal or not, with or without a
    count of valid cache slots; queries at absolute positions from
    ``start`` against a 64-slot cache; chunked by 16 and whole."""
    q, k, v = _attn_case(3, 2, 32, 64, 6, 2, 16, dtype)
    qpos = np.arange(start, start + 32)
    tol = 1e-5 if dtype == "float32" else 1e-2
    for chunk in (16, 1024):
        ref = ref_jit(lambda q, k, v: ref_layers.attention(
            q, k, v, jnp.asarray(qpos), valid, causal=causal, q_chunk=chunk),
            q, k, v)(q, k, v)
        got = layers.attention(to_torch(q), to_torch(k), to_torch(v),
                               torch.from_numpy(qpos), valid, causal=causal,
                               q_chunk=chunk)
        assert got.dtype == to_torch(q).dtype
        np.testing.assert_allclose(to_numpy(got), np.asarray(ref, np.float32),
                                   rtol=tol, atol=tol)
        if chunk == 16:
            chunked = got
    torch.testing.assert_close(chunked, got, rtol=1e-6, atol=1e-6)


def test_attention_logits_and_context_stay_f32_from_bf16():
    """bf16 q, k, v: the logits and the context are f32 products of the bf16
    inputs, the probabilities rounded to bf16 between them, as the
    reference's ``preferred_element_type=jnp.float32``: the same bits."""
    q, k, v = _attn_case(7, 1, 4, 8, 2, 1, 16, "bfloat16")
    got = layers.attention(to_torch(q), to_torch(k), to_torch(v),
                           torch.arange(4), None, causal=False)
    ref = np.asarray(ref_layers.attention(q, k, v, jnp.arange(4), None,
                                          causal=False), np.float32)
    np.testing.assert_array_equal(to_numpy(got), ref)


def test_attention_chunk_must_divide_the_queries():
    q, k, v = (to_torch(a) for a in _attn_case(5, 1, 48, 48, 2, 1, 8))
    with pytest.raises(ValueError, match="multiple of q_chunk 32"):
        layers.attention(q, k, v, torch.arange(48), None, causal=True,
                         q_chunk=32)
    with pytest.raises(AssertionError):
        ref_layers.attention(*_attn_case(5, 1, 48, 48, 2, 1, 8),
                             jnp.arange(48), None, causal=True, q_chunk=32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_and_projections_match_reference(dtype):
    """SwiGLU and the attention projections (qwen1.5's biases) on the
    reference's weights; bf16 bit for bit (silu rounded step by step)."""
    mp = ref_layers.init_mlp(jax.random.key(0), 48, 128, jnp.dtype(dtype))
    ap = ref_layers.init_attn(jax.random.key(1), 48, 4, 2, 16, 3, bias=True,
                              dtype=jnp.dtype(dtype))
    ap = ap._replace(bq=_normal(9, (4, 16), dtype))
    x = _normal(4, (2, 8, 48), dtype)
    mlp = layers.Mlp(48, 128, to_torch(mp.w_gate).dtype)
    attn = layers.Attention(48, 4, 2, 16, 3, bias=True,
                            dtype=to_torch(ap.wq).dtype)
    with torch.no_grad():
        for mod, src in ((mlp, mp), (attn, ap)):
            for name, prm in mod.named_parameters():
                prm.copy_(to_torch(getattr(src, name)))
    tol = 1e-5 if dtype == "float32" else 0.0
    ref = ref_jit(lambda x: ref_layers.mlp(mp, x), x)(x)
    np.testing.assert_allclose(to_numpy(mlp(to_torch(x))),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)
    refs = ref_jit(lambda x: ref_layers.qkv_proj(ap, x), x)(x)
    for r, g in zip(refs, attn.qkv_proj(to_torch(x))):
        np.testing.assert_allclose(to_numpy(g), np.asarray(r, np.float32),
                                   rtol=tol, atol=tol)
    ctx = _normal(6, (2, 8, 4, 16), dtype)
    ref = ref_jit(lambda c: ref_layers.out_proj(ap, c), ctx)(ctx)
    # two contracted dims: the sums run in another order (an ulp in bf16)
    otol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(to_numpy(attn.out_proj(to_torch(ctx))),
                               np.asarray(ref, np.float32), rtol=otol,
                               atol=otol)
    # the padded head (index 3 of 4) is zero in and out
    np.testing.assert_array_equal(np.asarray(ap.wq)[:, 3], 0)


def test_update_cache_writes_in_place_and_refuses_overflow():
    cache = torch.zeros(2, 6, 1, 4)
    new = torch.ones(2, 2, 1, 4)
    out = layers.update_cache(cache, new, 4)
    assert out is cache and cache[:, 4:].eq(1).all() and cache[:, :4].eq(0).all()
    ref = jax.lax.dynamic_update_slice(jnp.zeros((2, 6, 1, 4)),
                                       jnp.ones((2, 2, 1, 4)), (0, 5, 0, 0))
    # the reference clamps a start of 5 to 4 (slot 4 overwritten); the port
    # raises
    assert np.asarray(ref)[:, 4].sum() == 8
    with pytest.raises(ValueError, match="cannot take 2 at position 5"):
        layers.update_cache(cache, new, 5)

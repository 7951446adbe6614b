"""The port's Mamba2 / SSD layer (repro_torch.models.ssm) against the JAX
reference (repro.models.ssm) on the reference's weights and the same
seeded inputs: the chunked scan with and without a carried state, the
full block, and the single-token decode step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_parity import ref_jit, to_numpy, to_torch
from repro.models import ssm as ref_ssm
from repro_torch.carry import _load
from repro_torch.models import ssm

B, S, H, P, N = 2, 64, 4, 8, 16


def _scan_inputs(seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, S, H, P)).astype(f),
            np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f),
            np.log(np.arange(1, H + 1)).astype(f),
            rng.standard_normal((B, S, N)).astype(f),
            rng.standard_normal((B, S, N)).astype(f),
            rng.standard_normal((B, H, P, N)).astype(f))


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_matches_reference(chunk, with_state):
    """Four chunks and one, from zeros and from a carried state: y and the
    final state within 1e-5 (relative to their scale)."""
    xh, dt, a_log, b, c, s0 = _scan_inputs(0)
    init = s0 if with_state else None
    ry, rs = ref_ssm.ssd_scan(*(jnp.asarray(a) for a in (xh, dt, a_log, b, c)),
                              chunk, None if init is None
                              else jnp.asarray(init))
    py, ps = ssm.ssd_scan(*(torch.from_numpy(a) for a in (xh, dt, a_log, b, c)),
                          chunk, None if init is None
                          else torch.from_numpy(init))
    for r, g in ((ry, py), (rs, ps)):
        r = np.asarray(r)
        np.testing.assert_allclose(to_numpy(g), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())


def test_ssd_scan_refuses_a_ragged_chunk():
    xh, dt, a_log, b, c, _ = _scan_inputs(1)
    with pytest.raises(ValueError, match="not a multiple of the SSD chunk"):
        ssm.ssd_scan(*(torch.from_numpy(a) for a in (xh, dt, a_log, b, c)), 24)


def _block(dtype, heads=8, real_heads=8):
    d_inner = 8 * real_heads                    # head width P = 8
    p = ref_ssm.init_ssm(jax.random.key(0), 32, d_inner, N, heads,
                         real_heads, 4, jnp.dtype(dtype))
    port = ssm.Mamba2(32, d_inner, N, heads, real_heads, 4,
                      to_torch(p.w_z).dtype)
    _load(port, jax.tree.map(np.asarray, p))
    return p, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_forward_then_decode_matches_reference(dtype):
    """A 32-token prefill in chunks of 16 (state and conv lookbacks out),
    then 3 decode steps from that state, on TP-padded heads (6 real of 8):
    f32 within 1e-5, bf16 within 2e-2; the f32 SSM state stays f32."""
    p, port = _block(dtype, heads=8, real_heads=6)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((B, 32, 32)).astype(np.float32),
                    jnp.dtype(dtype))
    tol = 1e-5 if dtype == "float32" else 2e-2
    fwd = ref_jit(lambda p, x: ref_ssm.ssm_forward(
        p, x, heads=8, n_state=N, chunk=16), p, x)
    ry, rst = fwd(p, x)
    py, pst = ssm.ssm_forward(port, to_torch(x), chunk=16)
    np.testing.assert_allclose(to_numpy(py), np.asarray(ry, np.float32),
                               rtol=tol, atol=tol)
    assert pst.ssm.dtype == torch.float32
    step = ref_jit(lambda p, x, s: ref_ssm.ssm_decode_step(
        p, x, s, heads=8, n_state=N), p, x[:, :1], rst)
    for i in range(3):
        xi = jnp.asarray(rng.standard_normal((B, 1, 32)).astype(np.float32),
                         jnp.dtype(dtype))
        ry, rst = step(p, xi, rst)
        py, pst = ssm.ssm_decode_step(port, to_torch(xi), pst)
        np.testing.assert_allclose(to_numpy(py), np.asarray(ry, np.float32),
                                   rtol=tol, atol=tol)
        for r, g in zip(rst, pst):
            np.testing.assert_allclose(to_numpy(g), np.asarray(r, np.float32),
                                       rtol=tol, atol=tol)


def test_decode_steps_continue_the_chunked_forward():
    """Token-by-token decode from zeros equals the chunked forward on the
    same tokens (the reference's test_ssm_decode_matches_forward, one
    layer, in the port)."""
    _, port = _block("float32")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, 16, 32)).astype(np.float32))
    full, fst = ssm.ssm_forward(port, x, chunk=16)
    st = ssm.SsmState(torch.zeros(B, 8, 8, N), torch.zeros(B, 3, 64),
                      torch.zeros(B, 3, 2 * N))
    for i in range(16):
        y, st = ssm.ssm_decode_step(port, x[:, i:i + 1], st)
        torch.testing.assert_close(y[:, 0], full[:, i], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(st.ssm, fst.ssm, rtol=1e-4, atol=1e-4)


def test_softplus_is_logaddexp_everywhere():
    """``jax.nn.softplus`` is logaddexp(x, 0) at every x, past
    ``F.softplus``'s threshold of 20 too."""
    x = np.linspace(-30, 40, 701).astype(np.float32)
    np.testing.assert_allclose(to_numpy(ssm._softplus(torch.from_numpy(x))),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=0)

"""The port's Mixture-of-Experts (repro_torch.models.moe) against the JAX
reference (repro.models.moe) on the reference's weights and the same
seeded inputs: routing, capacity drops, ties in the router, the ordered
combine and the aux losses."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_parity import ref_jit, to_numpy, to_torch
from repro.models import moe as ref_moe
from repro_torch.carry import _load
from repro_torch.core.candidates import topk_desc
from repro_torch.models import moe


def _case(dtype, e=8, d=64, f=96, seed=0, tie=False):
    p = ref_moe.init_moe(jax.random.key(seed), d, e, f, jnp.dtype(dtype))
    if tie:      # experts 2 and 5 get the same router column: equal probs
        p = p._replace(router=p.router.at[:, 5].set(p.router[:, 2]))
    x = jnp.asarray(np.random.default_rng(seed + 10).standard_normal(
        (2, 32, d)).astype(np.float32), jnp.dtype(dtype))
    port = moe.Moe(d, e, f, to_torch(p.w_gate).dtype)
    _load(port, jax.tree.map(np.asarray, p))
    return p, x, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k,factor", [(2, 4.0), (4, 1.25), (4, 0.5),
                                          (8, 1.0)])
def test_moe_apply_matches_reference(dtype, top_k, factor):
    """Ample capacity (nothing dropped), the configs' 1.25 and tight
    capacity (a third or more of the assignments dropped): the outputs
    within 1e-6 in f32; in bf16 the same bits in over 99.9 % of entries
    (the combine adds in the reference's slot order, silu rounds as the
    reference's; a matmul's sums in another order move an addend by an
    ulp now and then); the aux losses within
    1e-6."""
    p, x, port = _case(dtype)
    fn = ref_jit(lambda p, x: ref_moe.moe_apply(p, x, top_k=top_k,
                                                capacity_factor=factor),
                 p, x)
    ref, raux = fn(p, x)
    got, route = moe.moe_apply(port, to_torch(x), top_k=top_k,
                               capacity_factor=factor)
    aux = moe.moe_aux(route)
    assert got.dtype == to_torch(x).dtype
    if dtype == "float32":
        np.testing.assert_allclose(to_numpy(got), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
    else:
        ref = np.asarray(ref, np.float32)
        assert np.mean(to_numpy(got) != ref) < 1e-3
        np.testing.assert_allclose(to_numpy(got), ref, rtol=1e-2, atol=1e-2)
    for r, g in zip(raux, aux):
        assert float(g) == pytest.approx(float(r), rel=1e-6, abs=1e-6)
    if factor < 1:
        assert float(aux.dropped_frac) > 0.3


def test_router_ties_put_the_lower_expert_first():
    """Two experts with one router column tie on every token: like
    ``lax.top_k``, the lower expert comes first (``torch.topk`` gives no
    such order), so the same tokens are dropped at capacity and the
    outputs agree."""
    p, x, port = _case("float32", tie=True)
    probs = torch.softmax(to_torch(x).reshape(64, 64) @ port.router, -1)
    assert torch.equal(probs[:, 2], probs[:, 5])
    vals, ids = topk_desc(probs, 8)
    rvals, rids = jax.lax.top_k(jnp.asarray(probs.numpy()), 8)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rvals))
    pos = ids.numpy()
    assert ((pos == 2).argmax(1) < (pos == 5).argmax(1)).all()
    for top_k, factor in ((2, 0.5), (4, 1.25)):
        ref, _ = ref_jit(lambda p, x: ref_moe.moe_apply(
            p, x, top_k=top_k, capacity_factor=factor), p, x)(p, x)
        got, _ = moe.moe_apply(port, to_torch(x), top_k=top_k,
                               capacity_factor=factor)
        np.testing.assert_allclose(to_numpy(got), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)


def test_capacity_matches_reference():
    for n, e, k, f in ((64, 8, 2, 1.25), (8, 16, 2, 1.25), (4096, 16, 2, 1.25),
                       (4096, 128, 8, 1.25), (1, 4, 1, 0.5)):
        assert moe.capacity(n, e, k, f) == ref_moe.capacity(n, e, k, f)

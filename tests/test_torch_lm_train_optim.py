"""The LM training path's optimizers and draws in the port against the JAX
reference on the CPU: the schedules, AdamW, Adafactor (factored and
unfactored leaves, f32 and bf16), global-norm clipping, the dense-vector
sketch and Count-Sketch gradient compression, ``prng.normal`` and
``zipf_token_stream``; and the reference's own optimizer tests, ported."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_parity import one_torch_thread, ref_jit  # noqa: F401
from repro import optim as ropt
from repro.core import sketch as rsketch
from repro.data import synthetic as rsyn
from repro_torch import optim
from repro_torch.carry import tensor_from_numpy
from repro_torch.core import prng, sketch
from repro_torch.data import synthetic
from repro_torch.optim import sketch_compress as sc

SHAPES = {"mat": (256, 160), "stack": (3, 136, 128), "vec": (200,),
          "small": (64, 16)}


def _tree(seed, dtype):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * 0.1).astype(np.float32).astype(
        dtype) for k, s in SHAPES.items()}


def _pair(tree):
    """(reference pytree, port dict of CPU tensors) of one numpy tree."""
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: tensor_from_numpy(v) for k, v in tree.items()})


def _close(port, ref, rtol, atol=0.0):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=rtol,
                               atol=atol)


def test_schedules_match_reference():
    for step in (0, 3, 9, 10, 11, 55, 99, 120):
        np.testing.assert_allclose(
            float(optim.linear_warmup(step, 10, 3e-4)),
            float(ropt.linear_warmup(step, 10, 3e-4)), rtol=1e-7)
        np.testing.assert_allclose(
            float(optim.cosine_schedule(step, 10, 100, 3e-4, 1e-5)),
            float(ropt.cosine_schedule(step, 10, 100, 3e-4, 1e-5)),
            rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_adamw_matches_reference(dtype):
    """Three AdamW steps (clipping on) on a seeded tree: parameters within
    an ulp of their dtype, moments within 1e-6 relative, the pre-clip
    norm within 1e-6 (f32) or 1e-5 (bf16 squares summed in f32 in
    another order)."""
    import ml_dtypes
    dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype
    rp, pp = _pair(_tree(0, dt))
    cfg = dict(lr=1e-2, weight_decay=0.1, clip_norm=0.5)
    rs, ps = ropt.adamw_init(rp), optim.adamw_init(pp)
    rupdate = None
    for i in range(3):
        rg, pg = _pair(_tree(10 + i, dt))
        rupdate = rupdate or ref_jit(
            lambda g, s, p: ropt.adamw_update(g, s, p,
                                              ropt.AdamWConfig(**cfg)),
            rg, rs, rp)
        rp, rs, rn = rupdate(rg, rs, rp)
        pp, ps, pn = optim.adamw_update(pg, ps, pp, optim.AdamWConfig(**cfg))
        np.testing.assert_allclose(float(pn), float(rn),
                                   rtol=1e-5 if dtype == "bfloat16" else 1e-6)
    tol = 1e-2 if dtype == "bfloat16" else 1e-6
    for k in SHAPES:
        _close(pp[k], rp[k], rtol=tol, atol=1e-7)
        _close(ps.m[k], rs.m[k], rtol=1e-6, atol=1e-9)
        _close(ps.v[k], rs.v[k], rtol=1e-6, atol=1e-12)


def test_clip_by_global_norm_matches_reference():
    rg, pg = _pair(_tree(3, np.float32))
    rc, rn = ropt.adamw.clip_by_global_norm(rg, 0.25)
    pc, pn = optim.adamw.clip_by_global_norm(pg, 0.25)
    np.testing.assert_allclose(float(pn), float(rn), rtol=1e-6)
    for k in SHAPES:
        _close(pc[k], rc[k], rtol=2e-6)


def test_adafactor_matches_reference():
    """Three steps with weight decay: ``mat`` and ``stack`` (over its last
    two axes) factored, ``vec`` and ``small`` not; one port leaf a
    reference leaf (no stacks)."""
    rp, pp = _pair(_tree(1, np.float32))
    cfg = dict(lr=1e-2, weight_decay=0.01)
    rs = ropt.adafactor_init(rp, ropt.AdafactorConfig(**cfg))
    ps = optim.adafactor_init(pp, optim.AdafactorConfig(**cfg))
    assert ps.factored == {"mat": True, "stack": True, "vec": False,
                           "small": False} == dict(rs.factored)
    assert ps.vr["stack"].shape == (3, 136) and ps.vc["stack"].shape == (3,
                                                                         128)
    # jitted with the ``factored`` flags held static (in the state, jit
    # would make them tracers the update cannot branch on)
    fact, rs = rs.factored, rs._replace(factored=None)
    rupdate = None
    for i in range(3):
        rg, pg = _pair(_tree(20 + i, np.float32))
        rupdate = rupdate or ref_jit(
            lambda g, s, p: (lambda o: (o[0], o[1]._replace(factored=None)))(
                ropt.adafactor_update(g, s._replace(factored=fact), p,
                                      ropt.AdafactorConfig(**cfg))),
            rg, rs, rp)
        rp, rs = rupdate(rg, rs, rp)
        pp, ps = optim.adafactor_update(pg, ps, pp,
                                        optim.AdafactorConfig(**cfg))
    for k in SHAPES:
        _close(pp[k], rp[k], rtol=1e-5, atol=1e-7)
        _close(ps.vr[k], rs.vr[k], rtol=1e-5)
        _close(ps.vc[k], rs.vc[k], rtol=1e-5)


def test_adafactor_stack_clips_over_the_whole_stack():
    """Three layers' (136, 128) weights as one stack clip the update's RMS
    over the stack, as the reference's stacked (3, 136, 128) leaf."""
    tree = _tree(4, np.float32)
    rp = {"w": jnp.asarray(tree["stack"])}
    pp = {f"l{i}": torch.from_numpy(tree["stack"][i].copy())
          for i in range(3)}
    stacks = [("l0", "l1", "l2")]
    cfg = dict(lr=1e-2)
    rs = ropt.adafactor_init(rp, ropt.AdafactorConfig(**cfg))
    ps = optim.adafactor_init(pp, optim.AdafactorConfig(**cfg), stacks)
    g = _tree(5, np.float32)["stack"] * np.array([1.0, 30.0, 0.01],
                                                 np.float32)[:, None, None]
    rp, _ = ropt.adafactor_update({"w": jnp.asarray(g)}, rs, rp,
                                  ropt.AdafactorConfig(**cfg))
    pp, _ = optim.adafactor_update(
        {f"l{i}": torch.from_numpy(g[i].copy()) for i in range(3)}, ps, pp,
        optim.AdafactorConfig(**cfg), stacks=stacks)
    for i in range(3):
        _close(pp[f"l{i}"], rp["w"][i], rtol=1e-5, atol=1e-7)


# ------------------------------------------- the reference's tests, ported
def _quadratic_problem(seed=0, n=256):
    rng = np.random.default_rng(seed)
    target = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32))
    return target, {"w": torch.zeros(n)}


def test_adamw_converges():
    target, params = _quadratic_problem()
    cfg = optim.AdamWConfig(lr=0.1, weight_decay=0.0)
    state = optim.adamw_init(params)
    for _ in range(200):
        params, state, _ = optim.adamw_update({"w": params["w"] - target},
                                              state, params, cfg)
    assert float(0.5 * torch.sum((params["w"] - target) ** 2)) < 1e-2


def test_adamw_weight_decay_shrinks():
    params = {"w": torch.full((8,), 10.0)}
    cfg = optim.AdamWConfig(lr=0.1, weight_decay=0.5, clip_norm=0.0)
    params, _, _ = optim.adamw_update({"w": torch.zeros(8)},
                                      optim.adamw_init(params), params, cfg)
    assert float(params["w"][0]) < 10.0


def test_adafactor_converges_matrix():
    rng = np.random.default_rng(1)
    target = torch.from_numpy(rng.normal(size=(256, 256)).astype(np.float32))
    params = {"w": torch.zeros((256, 256))}
    cfg = optim.AdafactorConfig(lr=0.3)
    state = optim.adafactor_init(params, cfg)
    assert state.vr["w"].shape == (256,) and state.vc["w"].shape == (256,)
    l0 = float(0.5 * torch.mean((params["w"] - target) ** 2))
    for _ in range(300):
        g = (params["w"] - target) / target.numel()
        params, state = optim.adafactor_update({"w": g}, state, params, cfg)
    assert float(0.5 * torch.mean((params["w"] - target) ** 2)) < 0.1 * l0


def test_sketch_compression_recovers_heavy_and_converges():
    """Sketch-compressed SGD on a quadratic converges, with the transmitted
    density ~top_k/n each round."""
    target, params = _quadratic_problem(n=512)
    ccfg = optim.SketchCompressConfig(rows=8, log2_cols=10, top_k=128,
                                      momentum=0.0)
    cstate = optim.sketch_compress_init(params, ccfg)
    l0 = float(0.5 * torch.sum((params["w"] - target) ** 2))
    for _ in range(100):
        upd, cstate, density = optim.compress_and_reduce(
            {"w": params["w"] - target}, cstate, ccfg)
        params = {"w": params["w"] - 0.5 * upd["w"]}
        assert float(density) <= 128 / 512 + 1e-3
    assert float(0.5 * torch.sum((params["w"] - target) ** 2)) < 0.01 * l0


def test_sketch_compression_error_feedback_accumulates():
    """Untransmitted coordinates stay in the error buffer (err + sent ==
    the sketch's estimate of g), and exactly top_k were sent."""
    n = 128
    params = {"w": torch.zeros(n)}
    ccfg = optim.SketchCompressConfig(rows=8, log2_cols=10, top_k=4,
                                      momentum=0.0)
    cstate = optim.sketch_compress_init(params, ccfg)
    g = torch.from_numpy(np.linspace(1.0, 2.0, n).astype(np.float32))
    upd, cstate, _ = optim.compress_and_reduce({"w": g}, cstate, ccfg)
    assert int((upd["w"].abs() > 0).sum()) == 4
    np.testing.assert_allclose((upd["w"] + cstate.error).numpy(), g.numpy(),
                               atol=0.35)


# ------------------------------------------------ dense sketch, compression
def test_tensor_sketch_matches_reference_across_chunks(monkeypatch):
    """The dense-vector sketch in chunks of 1 000 (a boundary inside the
    vector, a ragged last chunk): table and estimates within fp32
    rounding of the reference's one-shot."""
    monkeypatch.setattr(sketch, "TENSOR_CHUNK", 1000)
    rng = np.random.default_rng(0)
    g = rng.standard_normal(4500).astype(np.float32)
    rsk = rsketch.tensor_sketch_update(
        rsketch.init(jax.random.key(3), 8, 10), jnp.asarray(g))
    psk = sketch.tensor_sketch_update(
        sc.make_sketch(optim.SketchCompressConfig(rows=8, log2_cols=10,
                                                  seed=3), "cpu"),
        torch.from_numpy(g))
    table = np.asarray(rsk.table)
    np.testing.assert_allclose(psk.table.numpy(), table, rtol=0,
                               atol=1e-5 * np.abs(table).max())
    est = sketch.tensor_sketch_estimate(psk, 4500)
    np.testing.assert_allclose(
        est.numpy(), np.asarray(rsketch.tensor_sketch_estimate(rsk, 4500)),
        rtol=0, atol=1e-5 * np.abs(table).max())


def test_compress_and_reduce_matches_reference(monkeypatch):
    """Two rounds with momentum on a two-leaf gradient (f32 and bf16), in
    chunks of 1 024 coordinates: the same density; transmitted, error and
    momentum within fp32 rounding; the kept coordinates equal away from
    the threshold."""
    monkeypatch.setattr(sketch, "TENSOR_CHUNK", 1024)
    import ml_dtypes
    rng = np.random.default_rng(1)
    shapes = {"a": ((40, 50), np.float32), "b": ((300,), ml_dtypes.bfloat16)}
    params = {k: np.zeros(s, dt) for k, (s, dt) in shapes.items()}
    cfg = dict(rows=8, log2_cols=11, top_k=60, momentum=0.9, seed=2)
    rcfg, pcfg = ropt.SketchCompressConfig(**cfg), \
        optim.SketchCompressConfig(**cfg)
    rs = ropt.sketch_compress_init(_pair(params)[0], rcfg)
    ps = optim.sketch_compress_init(_pair(params)[1], pcfg)
    for _ in range(2):
        grads = {k: (rng.standard_normal(s) * rng.uniform(0.1, 3.0, s)
                     ).astype(dt) for k, (s, dt) in shapes.items()}
        rg, pg = _pair(grads)
        rup, rs, rd = ropt.compress_and_reduce(rg, rs, rcfg)
        pup, ps, pd = optim.compress_and_reduce(pg, ps, pcfg)
        assert float(pd) == float(rd)
        for k in shapes:
            _close(pup[k], rup[k], rtol=1e-5, atol=1e-5)
            kept_r = np.asarray(rup[k], np.float32) != 0
            kept_p = pup[k].float().numpy() != 0
            assert np.mean(kept_r != kept_p) <= 0.01
    off = 0
    for k, (s, _) in shapes.items():
        n = int(np.prod(s))
        for port, ref in ((ps.error, rs.error), (ps.momentum, rs.momentum)):
            _close(port[off:off + n], np.asarray(ref[k]).reshape(-1),
                   rtol=1e-5, atol=1e-5)
        off += n


# ----------------------------------------------------------------- draws
@pytest.mark.parametrize("seed,shape", [(0, (64, 8)), (7, (200_000,)),
                                        (11, (3, 50, 7))])
def test_normal_equals_jax_random_normal(seed, shape):
    """``prng.normal`` is ``jax.random.normal`` bit for bit (XLA:CPU's
    erfinv polynomial, log1p and fused multiply-adds, not torch's
    erfinv)."""
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    got = prng.normal(prng.key(seed), shape).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("vocab", [256, 32_000])
def test_zipf_token_stream_equals_reference(vocab):
    """The reference's tokens and labels bit for bit (its float32 cumsum in
    XLA's scan order, powf, the draws' threefry)."""
    for seed in (0, 9):
        want = rsyn.zipf_token_stream(jax.random.key(seed), 4, 300, vocab)
        got = synthetic.zipf_token_stream(prng.key(seed), 4, 300, vocab)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
        assert got["loss_mask"].shape == (4, 300)

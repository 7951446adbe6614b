"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU (marker ``cuda``) and skips
without one; this file imports neither jax nor the reference, so it runs
where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances, as chip_smoke.py holds the kernels:

* K1 segment_reduce: bit-exact on integer payloads; otherwise, against
  the plain version run in float64, within 1e-5 of each row's own
  magnitude Σ|v|_row plus 1e-6; every group width L, hub rows, empty
  rows, D ∈ {1, 2, 3}; two calls equal.
* K2 cic_splat: fixed-point integer sums, so two calls give equal bits
  and the grid equals the kernel's arithmetic replayed on the CPU
  (``_splat_fixed_point``) bit for bit; per cell within
  1e-5·Σ|contributions to the cell| + 1e-6 of the float64 plain version,
  masses scaled by 1e-4 and 1e4 too, and at path S's and path A's N and
  G (N = 10⁶ at G = 1024).
* K3 cic_gather: bit-exact against the float32 plain version (same
  roundings in the same order), and deterministic.
* K5a tsne_z / K5b tsne_forces: against the float64 plain version, Z and
  the KL rtol 1e-5, forces within 1e-4 of the largest force (the
  reference's own bar, tests/test_embed_backends.py); fp64 partials
  summed in a fixed order, so identical from call to call; K5a alone at
  N from 1 to 6000 with padding, dims 2 and 4, and on equal points,
  where Z = n_valid·(n_valid − 1) exactly (its tile-pair doubling and
  diagonal tiles); on the
  caller's rows and, through tsne_step_fused, on rows in the locality
  order; diagonal tiles, padded tails and whole tiles of padding.  K5b
  built without its exp skip or its per-tile masks (``-D`` variants)
  gives the same bits as the kernel, on exponents that straddle the
  floor 2^-126.
* K4 knn_dist_tiles: the same +inf pattern as the float64 plain version,
  finite values within 1e-5 of |q|² + |c|² (the fp32 Gram form rounds
  at that scale), identical from call to call.
* K6 hash_points: bit-exact against the plain version (cell keys from
  the same two roundings, then exact integer hashing), points on bin
  edges and outside the grid included.
* K7 sketch_update_table: bit-exact on integer counts (exact in any
  order below 2**24); weighted values per cell within
  1e-5·Σ|contributions to the cell| of the float64 plain version (float
  atomics add in a schedule-dependent order); R from 1 to 40 (past a
  warp), a streaming chunk's layout (live prefix, dead suffix of value
  0), groups of 32 with one live item; no −0.0 in a table that starts at
  +0.0.
* K8 sketch_estimate_table (hash, signed gather and median over rows in
  one kernel): bit-exact by int32 view, signed zeros included (a product
  with ±1 is exact; the median ranks values as the plain version's stable
  sort orders them and rounds the mean of the middle two as it does);
  explicit keys and the keys (0, start + j) into a caller's slice, R ∈
  {1, 3, 8, 16, 40}."""
import ctypes
import math

import numpy as np
import pytest
import torch

from repro_torch.core import (ann, candidates, coo, hashing, prng, quantize,
                              sketch, tsne)
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import cic
from repro_torch.kernels import hash_points as hp_mod
from repro_torch.kernels import knn_tile, ops
from repro_torch.kernels import segment_reduce as segred
from repro_torch.kernels import sketch_estimate as se_mod
from repro_torch.kernels import sketch_update as su_mod
from repro_torch.kernels import tsne_forces as tf

CASES = [(1, 16, 2), (16, 0, 2), (64, 3, 2), (33, 9, 3), (40, 5, 0),
         (0, 3, 2), (200, 40, 1), (3000, 15, 2)]


def _case(rows, fan, d, seed, integer):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 2 * fan + 1, size=rows) if fan else \
        np.zeros(rows, np.int64)
    if rows > 100:
        sizes[7] = 5000                       # a hub row
    bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    e = int(bounds[-1])
    shape = (e,) if d == 0 else (e, d)
    vals = (rng.integers(-1000, 1000, size=shape) if integer
            else rng.normal(size=shape)).astype(np.float32)
    return torch.from_numpy(vals), torch.from_numpy(bounds)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,fan,d", CASES)
@pytest.mark.parametrize("integer", [True, False])
def test_segment_reduce_kernel_matches_plain(card, rows, fan, d, integer):
    v, b = _case(rows, fan, d, rows + fan + d, integer)
    before = LAUNCHES["segment_reduce"]
    got = coo.segment_reduce(v.to(card), b.to(card)).cpu()
    torch.cuda.synchronize()
    assert LAUNCHES["segment_reduce"] == before + (rows > 0)
    want = segred.segment_reduce_torch(v.double(), b)
    assert got.shape == want.shape
    if integer:
        assert torch.equal(got, want.float())
    else:
        scale = segred.segment_reduce_torch(v.abs().double(), b)
        err = (got.double() - want).abs()
        assert bool((err <= 1e-5 * scale + 1e-6).all()), err.max().item()


def _sizes_case(sizes, d, seed, integer):
    bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    e = int(bounds[-1])
    rng = np.random.default_rng(seed)
    shape = (e,) if d == 0 else (e, d)
    vals = (rng.integers(-1000, 1000, size=shape) if integer
            else rng.normal(size=shape)).astype(np.float32)
    return torch.from_numpy(vals), torch.from_numpy(bounds)


def _check_segment_reduce(card, v, b, integer):
    """Kernel vs the plain version at the bar above; two calls equal."""
    got = segred.segment_reduce_cuda(v.to(card), b.to(card))
    again = segred.segment_reduce_cuda(v.to(card), b.to(card))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    got = got.cpu()
    want = segred.segment_reduce_torch(v.double(), b)
    assert got.shape == want.shape
    if integer:
        assert torch.equal(got, want.float())
    else:
        scale = segred.segment_reduce_torch(v.abs().double(), b)
        err = (got.double() - want).abs()
        assert bool((err <= 1e-5 * scale + 1e-6).all()), err.max().item()


# mean row length -> group width L: 1 -> 1, 3 -> 2, 7 -> 4, 15 -> 8,
# 31 -> 16, 63 -> 32
@pytest.mark.cuda
@pytest.mark.parametrize("fan,lanes", [(1, 1), (3, 2), (7, 4), (15, 8),
                                       (31, 16), (63, 32)])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("integer", [True, False])
def test_segment_reduce_every_group_width(card, fan, lanes, d, integer):
    rng = np.random.default_rng(fan + d)
    sizes = np.full(301, fan)
    sizes[::7] = 0                                      # empty rows
    sizes[1::5] = rng.integers(0, 2 * fan + 1, size=sizes[1::5].shape)
    v, b = _sizes_case(sizes, d, fan * d, integer)
    assert segred.group_lanes(len(sizes), v.shape[0]) == lanes
    _check_segment_reduce(card, v, b, integer)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("integer", [True, False])
def test_segment_reduce_hub_among_short_rows(card, d, integer):
    """One 1 500-edge hub among 15-edge rows (the dst side's shape): the
    hub's group strides it at L = 8."""
    sizes = np.full(2000, 15)
    sizes[::97] = 0
    sizes[1234] = 1500
    v, b = _sizes_case(sizes, d, d, integer)
    assert segred.group_lanes(len(sizes), v.shape[0]) == 8
    _check_segment_reduce(card, v, b, integer)


@pytest.mark.cuda
def test_segment_reduce_wrapper_rejects_bad_inputs(card):
    b = torch.tensor([0, 2], dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="float32"):
        segred.segment_reduce_cuda(torch.ones(2, device=card).double(), b)
    with pytest.raises(ValueError, match="int32"):
        segred.segment_reduce_cuda(torch.ones(2, device=card), b.long())
    with pytest.raises(ValueError, match="contiguous"):
        segred.segment_reduce_cuda(torch.ones(2, 2, device=card).T, b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        segred.segment_reduce_cuda(torch.ones(2), b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        coo.segment_reduce(torch.ones(2, device=card), b.cpu())
    # a float2 payload one float off its alignment: raises, never falls back
    before = LAUNCHES["segment_reduce"]
    buf = torch.zeros(2 * 2 + 1, device=card)
    with pytest.raises(ValueError, match="aligned"):
        segred.segment_reduce_cuda(buf[1:].view(2, 2), b)
    assert LAUNCHES["segment_reduce"] == before


def _cic_case(n, g, c, seed):
    """Cells from tsne._cic_weights on a random embedding (its extreme
    points sit on the grid's edge cells), plus points pinned to the four
    corner cells with f = 0 and f = 1."""
    rng = np.random.default_rng(seed)
    y = torch.from_numpy((rng.normal(size=(n, 2)) * 5).astype(np.float32))
    i0, f, _ = tsne._cic_weights(y, g)
    edge = torch.tensor([[0, 0], [0, g - 2], [g - 2, 0], [g - 2, g - 2]],
                        dtype=torch.int32)
    k = min(n, 8)
    i0[:k] = edge[torch.arange(k) % 4]
    f[:k] = torch.tensor([[0.0, 0.0], [1.0, 1.0]])[torch.arange(k) % 2]
    vals = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32))
    return i0.contiguous(), f.contiguous(), vals


CIC_CASES = [(1, 128, 3), (257, 128, 3), (5001, 128, 3), (3001, 1024, 3),
             (1000, 4, 1), (777, 64, 4)]


def _splat_fixed_point(i0, f, vals, g):
    """K2's arithmetic replayed on the CPU: the bound m, the scale 2^s,
    each corner product rounded to an int64 multiple of 2^-s, exact int64
    sums, one conversion a cell (csrc/cic.cu's note)."""
    n, c = vals.shape
    fx, fy = f[:, 0], f[:, 1]
    spread = ((1 - fx).abs() + fx.abs()) * ((1 - fy).abs() + fy.abs())
    m = (vals.abs().amax(1) * spread).max().item()
    if not math.isfinite(m):
        return torch.full((c, g, g), float("nan"))
    r, e = math.frexp(2.0 ** 60 / (n * m)) if m > 0 else (1.0, 1)
    s = e - 1 if r > 0.5 else e - 2                # 2^s < 2^60 / (N m)
    ix, iy = i0[:, 0].long(), i0[:, 1].long()
    ok = (ix >= 0) & (ix <= g - 2) & (iy >= 0) & (iy <= g - 2)
    ox, oy = 1 - fx, 1 - fy
    acc = torch.zeros(c * g * g, dtype=torch.int64)
    for (dx, dy), w in zip(((0, 0), (0, 1), (1, 0), (1, 1)),
                           (ox * oy, ox * fy, fx * oy, fx * fy)):
        q = torch.round((w[:, None] * vals).double() * 2.0 ** s).long()
        cell = (ix + dx) * g + iy + dy
        idx = cell[:, None] + torch.arange(c)[None, :] * g * g
        acc.index_add_(0, idx[ok].reshape(-1), q[ok].reshape(-1))
    return (acc.double() * 2.0 ** -s).float().view(c, g, g)


def _check_splat(card, i0, f, vals, g):
    """One K2 call on the card: deterministic, equal to the replay bit for
    bit, within the bar of the float64 plain version."""
    args = (i0.to(card), f.to(card), vals.to(card))
    before = LAUNCHES["cic_splat"]
    got = cic.cic_splat(*args, g)
    again = cic.cic_splat(*args, g)
    torch.cuda.synchronize()
    assert LAUNCHES["cic_splat"] == before + 2
    assert torch.equal(got, again)
    got = got.cpu()
    assert got.shape == (vals.shape[1], g, g)
    assert torch.equal(got, _splat_fixed_point(i0, f, vals, g))
    want = cic.cic_splat_torch(i0, f.double(), vals.double(), g)
    scale = cic.cic_splat_torch(i0, f.double(), vals.double().abs(), g)
    err = (got.double() - want).abs()
    assert bool((err <= 1e-5 * scale + 1e-6).all()), err.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,g,c", CIC_CASES)
@pytest.mark.parametrize("mass", [1e-4, 1.0, 1e4])
def test_cic_splat_kernel_matches_plain(card, n, g, c, mass):
    i0, f, vals = _cic_case(n, g, c, n + g)
    _check_splat(card, i0, f, vals * mass, g)


@pytest.mark.cuda
@pytest.mark.parametrize("n,g,spread", [(207_759, 128, 30.0),
                                        (1_000_000, 1024, 100.0)])
def test_cic_splat_at_the_paths_shapes(card, n, g, spread):
    """Path S's and path A's N and G, the masses (1, y_x, y_y) that
    fft_repulsion splats, y as wide as those paths' maps."""
    rng = np.random.default_rng(n)
    y = torch.from_numpy((rng.normal(size=(n, 2)) * spread
                          ).astype(np.float32))
    i0, f, _ = tsne._cic_weights(y, g)
    vals = torch.stack([torch.ones(n), y[:, 0], y[:, 1]], 1)
    _check_splat(card, i0.contiguous(), f.contiguous(), vals, g)


@pytest.mark.cuda
def test_cic_splat_non_finite_mass_poisons_the_grid(card):
    i0, f, vals = _cic_case(100, 16, 3, 1)
    vals[5, 1] = float("inf")
    got = cic.cic_splat(i0.to(card), f.to(card), vals.to(card), 16)
    assert bool(torch.isnan(got).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,g", [(5001, 128), (20_000, 1024)])
def test_fft_repulsion_twice_gives_equal_bits(card, n, g):
    rng = np.random.default_rng(g)
    y = torch.from_numpy((rng.normal(size=(n, 2)) * 20).astype(np.float32)
                         ).to(card)
    rep, z = tsne.fft_repulsion(y, g)
    rep2, z2 = tsne.fft_repulsion(y, g)
    torch.cuda.synchronize()
    assert torch.equal(rep, rep2) and torch.equal(z, z2)
    _, zw = tsne.fft_repulsion(y.cpu(), g)        # the CPU path's float splat
    assert abs(z.item() - zw.item()) <= 1e-4 * zw.item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,g,c", CIC_CASES)
def test_cic_gather_kernel_matches_plain_bit_for_bit(card, n, g, c):
    i0, f, _ = _cic_case(n, g, c, n + g + 1)
    fields = torch.from_numpy(np.random.default_rng(n).normal(
        size=(c + 1, g, g)).astype(np.float32))
    args = (fields.to(card), i0.to(card), f.to(card))
    before = LAUNCHES["cic_gather"]
    got = cic.cic_gather(*args)
    again = cic.cic_gather(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["cic_gather"] == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), cic.cic_gather_torch(fields, i0, f))
    assert torch.equal(got, cic.cic_gather_torch(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("n,g,c", [(5001, 128, 4), (3001, 1024, 4),
                                   (777, 64, 3)])
def test_cic_gather_channels_last_view_bit_for_bit(card, n, g, c):
    """The layout fft_repulsion hands K3: a (C, G, G) view of a
    channels-last (G, G, C) tensor, read in place; the same values as a
    plain contiguous (C, G, G) tensor give the same bits."""
    i0, f, _ = _cic_case(n, g, c, n + g + 2)
    cl = torch.from_numpy(np.random.default_rng(g).normal(
        size=(g, g, c)).astype(np.float32))
    view = cl.to(card).permute(2, 0, 1)
    plain = view.contiguous()
    i0d, fd = i0.to(card), f.to(card)
    got = cic.cic_gather(view, i0d, fd)
    torch.cuda.synchronize()
    assert torch.equal(got, cic.cic_gather(plain, i0d, fd))
    assert torch.equal(got.cpu(), cic.cic_gather_torch(cl.permute(2, 0, 1),
                                                        i0, f))


def _tsne_inputs(n, dh, dims, seed):
    """Clustered x, spread y, calibrated stats with random weights."""
    rng = np.random.default_rng(seed)
    cent = rng.uniform(-3, 3, size=(4, dh))
    x = (cent[rng.integers(0, 4, n)] + 0.3 * rng.normal(size=(n, dh)))
    x = torch.from_numpy(x.astype(np.float32))
    y = torch.from_numpy((rng.normal(size=(n, dims)) * 3).astype(np.float32))
    w = torch.from_numpy(rng.uniform(1, 100, n).astype(np.float32))
    st = tsne.calibrate_stats(x, min(30.0, max(n - 1, 1) / 3), weights=w)
    return x, y, st


def _tsne_case(n, dh, dims, seed, block=128):
    """Padded fused-step inputs; rows past n are padding (w = 0, zp = 1)."""
    x, y, st = _tsne_inputs(n, dh, dims, seed)
    stats = tf.step_stats(st.beta, st.zp, st.shift, st.w, block)
    return tf.pad_rows(x, block), tf.pad_rows(y, block), stats


TSNE_CASES = [(5, 8, 2), (300, 8, 2), (1000, 8, 2), (1000, 3, 2),
              (517, 10, 3), (400, 32, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,dh,dims", TSNE_CASES)
@pytest.mark.parametrize("exag", [1.0, 12.0])
def test_tsne_kernels_match_plain(card, n, dh, dims, exag):
    x, y, stats = _tsne_case(n, dh, dims, n + dh)
    xd, yd, sd = x.to(card), y.to(card), stats.to(card)
    before = (LAUNCHES["tsne_z"], LAUNCHES["tsne_forces"])
    f, parts, z = tf.tsne_step(xd, yd, sd, exag, n_valid=n)
    f2, parts2, z2 = tf.tsne_step(xd, yd, sd, exag, n_valid=n)
    torch.cuda.synchronize()
    assert (LAUNCHES["tsne_z"], LAUNCHES["tsne_forces"]) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(f, f2) and torch.equal(parts, parts2) \
        and torch.equal(z, z2)
    zw = tf.tsne_z_torch(y.double(), n)
    fw, pw = tf.tsne_forces_torch(x.double(), y.double(), stats.double(),
                                  zw, exag, n)
    assert f.shape == (x.shape[0], dims)
    assert abs(z.item() - zw.item()) <= 1e-5 * zw.item()
    scale = fw.abs().max().item()
    assert (f.cpu().double() - fw).abs().max().item() <= 1e-4 * scale
    kl = tf.step_kl(parts, z, exag).item()
    klw = tf.step_kl(pw, zw, exag).item()
    assert abs(kl - klw) <= 1e-5 * max(1.0, abs(klw))
    assert bool((f[n:] == 0).all())


def _check_forces(f, parts, z, x, y, stats, exag, n):
    """Forces, Z and KL against the float64 plain versions."""
    zw = tf.tsne_z_torch(y.double(), n)
    fw, pw = tf.tsne_forces_torch(x.double(), y.double(), stats.double(),
                                  zw, exag, n)
    assert abs(z.item() - zw.item()) <= 1e-5 * zw.item()
    scale = fw.abs().max().item()
    assert (f.cpu().double() - fw[:f.shape[0]]).abs().max().item() \
        <= 1e-4 * scale
    kl = tf.step_kl(parts, z, exag).item()
    klw = tf.step_kl(pw, zw, exag).item()
    assert abs(kl - klw) <= 1e-5 * max(1.0, abs(klw))


@pytest.mark.cuda
@pytest.mark.parametrize("n,block", [(1300, 512), (6000, 512), (129, 128)])
def test_tsne_forces_padded_tail_and_diagonal_tiles(card, n, block):
    """n_valid not a multiple of 128: the diagonal tiles, a tile half
    valid and half padding, and whole tiles of padding rows."""
    x, y, stats = _tsne_case(n, 8, 2, n, block)
    xd, yd, sd = x.to(card), y.to(card), stats.to(card)
    f, parts, z = tf.tsne_step(xd, yd, sd, 12.0, n_valid=n)
    f2, parts2, _ = tf.tsne_step(xd, yd, sd, 12.0, n_valid=n)
    torch.cuda.synchronize()
    assert torch.equal(f, f2) and torch.equal(parts, parts2)
    assert bool((f[n:] == 0).all())
    _check_forces(f, parts, z, x, y, stats, 12.0, n)


@pytest.mark.cuda
@pytest.mark.parametrize("exag", [1.0, 12.0])
def test_tsne_fused_step_in_both_row_orders(card, exag):
    """K5b on the caller's rows and, through tsne_step_fused, on rows in
    the locality order, forces handed back in the caller's order: both
    against the plain version, the fused step deterministic."""
    n = 3001
    x, y, st = _tsne_inputs(n, 8, 2, 11)
    stats = tf.step_stats(st.beta, st.zp, st.shift, st.w, 128)
    xp, yp = tf.pad_rows(x, 128), tf.pad_rows(y, 128)
    f, parts, z = tf.tsne_step(xp.to(card), yp.to(card), stats.to(card),
                               exag, n_valid=n)
    _check_forces(f[:n], parts, z, xp, yp, stats, exag, n)
    args = [t.to(card) for t in (x, y, st.beta, st.zp)]
    kw = dict(shift=st.shift.to(card), weights=st.w.to(card),
              exaggeration=exag, block=128, return_kl=True)
    before = LAUNCHES["tsne_forces"]
    fm, klm = tf.tsne_step_fused(*args, **kw)
    fm2, klm2 = tf.tsne_step_fused(*args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["tsne_forces"] == before + 2
    assert torch.equal(fm, fm2) and torch.equal(klm, klm2)
    zw = tf.tsne_z_torch(yp.double(), n)
    fw, pw = tf.tsne_forces_torch(xp.double(), yp.double(), stats.double(),
                                  zw, exag, n)
    assert (fm.cpu().double() - fw[:n]).abs().max().item() \
        <= 1e-4 * fw.abs().max().item()
    klw = tf.step_kl(pw, zw, exag).item()
    assert abs(klm.item() - klw) <= 1e-5 * max(1.0, abs(klw))


def _forces_built_with(monkeypatch, define, *args):
    """tsne_forces_cuda through the kernel built with ``-D<define>``."""
    from repro_torch.kernels import _build
    fn = getattr(_build.load("tsne_forces", (define,)), "tsne_forces_f32")
    fn.argtypes, fn.restype = tf._F_SIG, ctypes.c_int
    entry = _build.entry
    with monkeypatch.context() as m:
        m.setattr(_build, "entry", lambda name, sym, sig: fn
                  if sym == "tsne_forces_f32" else entry(name, sym, sig))
        return tf.tsne_forces_cuda(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("ordered", [False, True])
def test_tsne_forces_steps_change_no_bit(card, monkeypatch, ordered):
    """Pairs whose exponents straddle the floor: with beta scaled by 5,
    3.7 % of the pairs have an exponent -beta d^2 - shift in
    [ln 2^-126, ln 2^-100] and 1.4 % in [ln 2^-150, ln 2^-126), ln 2^-126
    = -87.3365; the warps of the locality order skip the exps of ~72 % of
    their columns, those of the caller's order almost none.  The kernel
    with the warp skip equals the
    kernel built without it bit for bit (a skipped 2^e is the +0 that
    ex2.approx.ftz returns below 2^-126), and so does the kernel built
    with every tile masked; all within tolerance of the plain version."""
    n = 2000
    x, y, st = _tsne_inputs(n, 8, 2, 12)
    beta = st.beta * 5.0
    if ordered:
        o = tf.locality_order(x)
        x, y, beta = x[o], y[o], beta[o]
        st = tsne.PointStats(beta, st.shift[o], st.zp[o], st.w[o])
    stats = tf.step_stats(beta, st.zp, st.shift, st.w, 128)
    d = [t.to(card) for t in (tf.pad_rows(x, 128), tf.pad_rows(y, 128),
                              stats)]
    z = tf.tsne_z_cuda(d[1], n)
    args = (*d, z, 12.0, n)
    f, parts = tf.tsne_forces_cuda(*args)
    for define in ("SNS_K5B_NO_EXP_SKIP", "SNS_K5B_NO_TILE_MASKS"):
        g, gparts = _forces_built_with(monkeypatch, define, *args)
        torch.cuda.synchronize()
        assert torch.equal(f, g) and torch.equal(parts, gparts), define
    _check_forces(f[:n], parts, z, *[t.cpu() for t in d], 12.0, n)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 127, 128, 129, 1300, 6000])
@pytest.mark.parametrize("dims", [2, 4])
@pytest.mark.parametrize("padded", [False, True])
def test_tsne_z_matches_float64(card, n, dims, padded):
    """K5a alone: tile pairs below, on and astride the 512-row tile (one
    tile, a partial diagonal tile, interior and padded tiles), with
    n_valid = n or below it."""
    rng = np.random.default_rng(n * dims)
    y = torch.from_numpy((rng.normal(size=(n, dims)) * 5).astype(np.float32))
    n_valid = n - max(1, n // 10) if padded else n
    yd = y.to(card)
    before = LAUNCHES["tsne_z"]
    z = tf.tsne_z_cuda(yd, n_valid)
    z2 = tf.tsne_z_cuda(yd, n_valid)
    torch.cuda.synchronize()
    assert LAUNCHES["tsne_z"] == before + 2
    assert z.dtype == torch.float32 and z.shape == () and z.is_cuda
    assert torch.equal(z, z2)
    zw = tf.tsne_z_torch(y.double(), n_valid).item()
    assert abs(z.item() - zw) <= 1e-5 * zw


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [2, 4])
def test_tsne_z_on_equal_points_counts_every_pair(card, dims):
    """Every valid pair adds exactly 1: Z = n_valid·(n_valid − 1), which
    needs the off-diagonal tiles doubled and the diagonal tiles' j = i
    left out; the padding rows (zeros, unlike the points) add nothing."""
    n_valid = 3001
    y = torch.full((n_valid, dims), 1.5)
    y[:, 0] = -2.0
    yp = tf.pad_rows(y, 1024)
    z = tf.tsne_z_cuda(yp.to(card), n_valid)
    assert z.item() == n_valid * (n_valid - 1)


@pytest.mark.cuda
def test_new_wrappers_reject_bad_inputs(card):
    i0 = torch.zeros((4, 2), dtype=torch.int32, device=card)
    f = torch.zeros((4, 2), device=card)
    vals = torch.ones((4, 3), device=card)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cic.cic_splat_cuda(i0.cpu(), f, vals, 8)
    with pytest.raises(ValueError, match="int32"):
        cic.cic_splat_cuda(i0.long(), f, vals, 8)
    with pytest.raises(ValueError, match="float32"):
        cic.cic_gather_cuda(torch.ones((3, 8, 8), device=card).double(),
                            i0, f)
    with pytest.raises(ValueError, match="contiguous"):
        cic.cic_splat_cuda(i0, f, torch.ones((3, 4), device=card).T, 8)
    y = torch.zeros((8, 2), device=card)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tf.tsne_z_cuda(y.cpu())
    with pytest.raises(ValueError, match="at most 32"):
        tf.tsne_forces_cuda(torch.zeros((8, 33), device=card), y,
                            torch.ones((8, 4), device=card),
                            torch.ones((), device=card), 1.0)


def _knn_tile_case(t, b, d, seed):
    """Random tiles with window padding (cid −1), self pairs, padded query
    rows and a half-empty last tile."""
    rng = np.random.default_rng(seed)
    c = 3 * b
    qx = rng.normal(size=(t, b, d)).astype(np.float32) * 3
    cx = rng.normal(size=(t, c, d)).astype(np.float32) * 3
    qid = rng.integers(0, 10 * b, (t, b)).astype(np.int32)
    cid = rng.integers(0, 10 * b, (t, c)).astype(np.int32)
    cid[0, :b] = -1                                  # left halo of tile 0
    qid[-1, b // 2:] = -1
    cid[-1, c // 2:] = -1
    cid[:, b:2 * b] = qid                            # the tile's own rows
    return [torch.from_numpy(a) for a in (qx, qid, cx, cid)]


def _layout_case(n, k, d, seed):
    """A real probe layout of ``n`` blob points (partial last tile)."""
    rng = np.random.default_rng(seed)
    cent = rng.uniform(0, 1, (10, d))
    x = torch.from_numpy((cent[rng.integers(0, 10, n)] + 0.02 * rng.normal(
        size=(n, d))).astype(np.float32))
    rot = torch.linalg.qr(torch.randn((d, d), generator=torch.Generator(
    ).manual_seed(seed)))[0]
    return list(ann._probe_layout(x, k, rot, ann.AnnConfig())[:4])


def _check_knn_tile(card, args):
    qx, qid, cx, cid = args
    dev = [a.to(card) for a in args]
    before = LAUNCHES["knn_dist_tiles"]
    got = knn_tile.distance_tiles(*dev)
    again = knn_tile.distance_tiles_cuda(*dev)
    torch.cuda.synchronize()
    assert LAUNCHES["knn_dist_tiles"] == before + 2
    assert torch.equal(got, again)
    want = knn_tile.distance_tiles_torch(qx.double(), qid, cx.double(), cid)
    got = got.cpu().double()
    assert got.shape == want.shape
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    scale = (qx.double() ** 2).sum(2)[:, :, None] \
        + (cx.double() ** 2).sum(2)[:, None, :]
    fin = torch.isfinite(want)
    err = (got - want).abs()[fin]
    assert bool((err <= 1e-5 * scale[fin]).all()), err.max().item()


KNN_TILE_CASES = [(1, 128, 8), (37, 128, 8), (5, 200, 3), (3, 64, 64),
                  (2, 90, 17), (4, 128, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,b,d", KNN_TILE_CASES)
def test_knn_tile_kernel_matches_plain(card, t, b, d):
    _check_knn_tile(card, _knn_tile_case(t, b, d, t + b + d))


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d", [(5000, 90, 8), (1000, 15, 4)])
def test_knn_tile_kernel_on_a_probe_layout(card, n, k, d):
    _check_knn_tile(card, _layout_case(n, k, d, n))


@pytest.mark.cuda
def test_knn_tile_wrapper_rejects_bad_inputs(card):
    qx, qid, cx, cid = [a.to(card) for a in _knn_tile_case(2, 8, 3, 0)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        knn_tile.distance_tiles_cuda(qx.cpu(), qid, cx, cid)
    with pytest.raises(ValueError, match="float32"):
        knn_tile.distance_tiles_cuda(qx.double(), qid, cx, cid)
    with pytest.raises(ValueError, match="int32"):
        knn_tile.distance_tiles_cuda(qx, qid.long(), cx, cid)
    with pytest.raises(ValueError, match="shapes disagree"):
        knn_tile.distance_tiles_cuda(qx, qid, cx[:, :5], cid)
    with pytest.raises(ValueError, match="D must be"):
        z = torch.zeros((2, 8, 65), device=card)
        knn_tile.distance_tiles_cuda(z, qid, torch.zeros((2, 24, 65),
                                                         device=card), cid)
    with pytest.raises(ValueError, match="contiguous"):
        knn_tile.distance_tiles_cuda(qx.transpose(0, 1).contiguous(
        ).transpose(0, 1), qid, cx, cid)


def _params(rows, seed):
    return hashing.make_params(prng.key(seed), rows)


def _hash_case(n, d, bins, seed):
    """Points on a [0, 1] grid: uniform ones, ones exactly on bin edges
    and ones outside the grid (clamped to the edge cells)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.2, 1.2, size=(n, d)).astype(np.float32)
    pts[: n // 3] = (rng.integers(0, bins + 1, size=(n // 3, d))
                     / bins).astype(np.float32)
    grid = quantize.GridSpec(dims=d, bins=bins, lo=np.zeros(d),
                             hi=np.ones(d))
    return grid, torch.from_numpy(pts)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,bins,l2c", [(100_003, 2, 1000, 6),
                                          (100_003, 8, 25, 18),
                                          (4099, 12, 16, 22), (1, 3, 7, 1),
                                          (0, 4, 8, 10)])
def test_hash_points_kernel_matches_plain(card, n, d, bins, l2c):
    grid, pts = _hash_case(n, d, bins, n + d)
    params = _params(16, d)
    before = LAUNCHES["hash_points"]
    b, s = hp_mod.hash_points(params.to(card), grid, pts.to(card), l2c)
    torch.cuda.synchronize()
    assert LAUNCHES["hash_points"] == before + (n > 0)
    wb, ws = hp_mod.hash_points_torch(params, grid, pts, l2c)
    assert b.dtype == s.dtype == torch.int64 and b.shape == (16, n)
    assert torch.equal(b.cpu(), wb) and torch.equal(s.cpu(), ws)


def _keys(n, seed, universe):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, universe, size=n, dtype=np.uint64) \
        * np.uint64(0x9E3779B97F4A7C15)
    return (torch.from_numpy((k >> np.uint64(32)).astype(np.int64)),
            torch.from_numpy((k & np.uint64(0xFFFFFFFF)).astype(np.int64)))


def _cell_scale(params, hi, lo, v, start):
    """Σ|contributions| to each cell, its starting value included,
    float64."""
    log2_cols = start.shape[1].bit_length() - 1
    b, _ = hashing.hashes(params, hi, lo, log2_cols)
    base = (torch.arange(params.rows) << log2_cols)[:, None]
    flat = start.abs().double().view(-1)
    flat.index_add_(0, (base | b).reshape(-1),
                    v.abs().double().expand(params.rows, -1).reshape(-1))
    return flat.view(params.rows, -1)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,l2c,n", [(1, 6, 50_000), (16, 18, 65_536),
                                        (16, 22, 100_003), (5, 10, 1)])
@pytest.mark.parametrize("weighted", [False, True])
def test_sketch_update_kernel_matches_plain(card, rows, l2c, n, weighted):
    params = _params(rows, l2c)
    hi, lo = _keys(n, n + rows, universe=max(n // 4, 1))
    rng = np.random.default_rng(rows)
    v = torch.from_numpy((rng.normal(size=n) if weighted else
                          rng.integers(-3, 4, size=n)).astype(np.float32))
    v[::7] = 0.0                                    # skipped, changes no bit
    start = torch.from_numpy(rng.integers(-5, 5, size=(rows, 1 << l2c))
                             .astype(np.float32))
    before = LAUNCHES["sketch_update_table"]
    got = su_mod.sketch_update(start.to(card), params.to(card), hi.to(card),
                               lo.to(card), v.to(card)).cpu()
    torch.cuda.synchronize()
    assert LAUNCHES["sketch_update_table"] == before + 1
    if not weighted:
        want = su_mod.sketch_update_torch(start.clone(), params, hi, lo, v)
        assert torch.equal(got, want)
    else:
        want = su_mod.sketch_update_torch(start.double(), params, hi, lo, v)
        scale = _cell_scale(params, hi, lo, v, start)
        err = (got.double() - want).abs()
        assert bool((err <= 1e-5 * scale).all()), err.max().item()


def _check_update(card, params, hi, lo, v, start, weighted):
    """K7 against the plain version: integer tables bit for bit, weighted
    ones per cell within 1e-5·Σ|contrib|; a table that starts at +0.0
    holds no −0.0."""
    before = LAUNCHES["sketch_update_table"]
    got = su_mod.sketch_update_cuda(start.to(card), params.to(card),
                                    hi.to(card), lo.to(card),
                                    v.to(card)).cpu()
    torch.cuda.synchronize()
    assert LAUNCHES["sketch_update_table"] == before + 1
    if not weighted:
        want = su_mod.sketch_update_torch(start.clone(), params, hi, lo, v)
        assert torch.equal(got, want)
    else:
        want = su_mod.sketch_update_torch(start.double(), params, hi, lo, v)
        scale = _cell_scale(params, hi, lo, v, start)
        err = (got.double() - want).abs()
        assert bool((err <= 1e-5 * scale).all()), err.max().item()
    if not bool(torch.signbit(start).any()):
        assert not bool(((got == 0) & torch.signbit(got)).any())
    return got


def _chunk_runs(n, live, seed):
    """A streaming chunk's runs: ``live`` distinct sorted keys with
    counts, then a dead suffix of count 0 on the chunk's largest key."""
    rng = np.random.default_rng(seed)
    k = np.unique(rng.integers(0, 2 ** 40, size=2 * live, dtype=np.uint64))
    k = np.sort(rng.choice(k, size=live, replace=False))
    keys = np.concatenate([k, np.full(n - live, k[-1], np.uint64)])
    counts = np.zeros(n, np.float32)
    counts[:live] = rng.integers(1, 60, size=live)
    return (torch.from_numpy((keys >> np.uint64(32)).astype(np.int64)),
            torch.from_numpy((keys & np.uint64(0xFFFFFFFF)).astype(np.int64)),
            torch.from_numpy(counts))


@pytest.mark.cuda
@pytest.mark.parametrize("signed", [False, True])
def test_sketch_update_on_a_streaming_chunk(card, signed):
    """Path I's chunk: 65 536 run slots, the first 33 650 live, R 16, C
    2^18; counts, or counts with random signs (cells that cancel to
    zero must come out +0.0)."""
    hi, lo, v = _chunk_runs(65_536, 33_650, 7)
    if signed:
        v = v * torch.from_numpy(np.random.default_rng(8).choice(
            [-1.0, 1.0], size=v.shape[0]).astype(np.float32))
    got = _check_update(card, _params(16, 7), hi, lo, v,
                        torch.zeros((16, 1 << 18)), False)
    assert float(got.abs().sum()) <= 16 * float(v.abs().sum())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 5, 40])
@pytest.mark.parametrize("weighted", [False, True])
def test_sketch_update_row_counts(card, rows, weighted):
    """One row, an odd count, and R past a warp (40 parameter triples
    staged by one block)."""
    n = 100_003
    hi, lo = _keys(n, rows, universe=n // 3)
    rng = np.random.default_rng(rows)
    v = torch.from_numpy((rng.normal(size=n) if weighted else
                          rng.integers(-3, 4, size=n)).astype(np.float32))
    v[::5] = 0.0
    _check_update(card, _params(rows, rows + 1), hi, lo, v,
                  torch.zeros((rows, 1 << 14)), weighted)


@pytest.mark.cuda
def test_sketch_update_group_with_one_live_item(card):
    """Groups of 32 with a single live item (first, middle, last lane)
    among dead groups: each adds its R cells and nothing else does."""
    n = 32 * 64
    hi, lo = _keys(n, 3, universe=10 ** 9)
    v = torch.zeros(n)
    live = [32 * 5, 32 * 17 + 13, 32 * 63 + 31]
    v[live] = torch.tensor([2.0, -3.0, 7.0])
    got = _check_update(card, _params(16, 3), hi, lo, v,
                        torch.zeros((16, 1 << 18)), False)
    assert int((got != 0).sum()) <= 16 * len(live)


def _estimate_table(rows, l2c, seed):
    """Values ~100, a third of the cells 0 (so −0.0 comes out under a
    negative sign) and a fifth small integers (ties across rows)."""
    table = torch.randn((rows, 1 << l2c), generator=torch.Generator(
    ).manual_seed(seed)) * 100
    table[:, ::3] = 0.0
    table[:, 1::5] = table[:, 1::5].round().clamp(-2, 2)
    return table


def _same_bits(got, want):
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("q,l2c", [(0, 18), (7, 22), (1000, 6),
                                   (40_000, 18), (40_000, 22)])
@pytest.mark.parametrize("rows", [1, 3, 8, 16, 40, 129, 300])
def test_sketch_estimate_kernel_matches_plain(card, rows, q, l2c):
    """Both key sources, one launch each: explicit keys and the keys (0,
    start + j) from a start past 0 into a slice of a larger tensor; by
    int32 view against the plain version on the CPU, signed zeros
    included.  R 8 and 16 take the register kernel, up to 128 the general
    one (40: past a warp of triples), above it a warp a query."""
    params = _params(rows, q + l2c)
    hi, lo = _keys(q, q, universe=max(q // 3, 1))
    table = _estimate_table(rows, l2c, q)
    dt, dp = table.to(card), params.to(card)
    before = LAUNCHES["sketch_estimate_table"]
    got = se_mod.estimate(dt, dp, hi.to(card), lo.to(card))
    torch.cuda.synchronize()
    assert LAUNCHES["sketch_estimate_table"] == before + (q > 0)
    want = se_mod.estimate_torch(table, params, hi, lo)
    _same_bits(got, want)
    if q == 40_000:                                 # −0.0 estimates come out
        assert bool((want.view(torch.int32) == -(1 << 31)).any())
    start, pad = (1 << 31) - q // 2, 5
    out = torch.full((q + 2 * pad,), 7.0, device=card)
    before = LAUNCHES["sketch_estimate_table"]
    se_mod.estimate_range(dt, dp, start, out[pad:pad + q])
    torch.cuda.synchronize()
    assert LAUNCHES["sketch_estimate_table"] == before + (q > 0)
    _same_bits(out[pad:pad + q], se_mod.estimate_range_torch(
        table, params, start, q))
    assert bool((out[:pad] == 7.0).all() and (out[pad + q:] == 7.0).all())


@pytest.mark.cuda
def test_sketch_module_and_ops_run_the_kernels(card):
    """sketch.update / estimate / tensor_sketch_estimate and the three
    ops wrappers launch K6-K8 on CUDA tensors (one K8 launch a call) and
    agree with their CPU runs bit for bit."""
    grid, pts = _hash_case(20_000, 4, 16, 1)
    params = _params(8, 2)
    sk0 = sketch.init(params, 12)
    kh, kl = quantize.points_to_keys(grid, pts)
    dev = sketch.init(params.to(card), 12)
    LAUNCHES.clear()
    sk = sketch.update_runs(dev, candidates.sorted_runs(kh.to(card),
                                                        kl.to(card)))
    est = sketch.estimate(sk, kh[:500].to(card), kl[:500].to(card))
    fused = ops.sketch_update_fused(dev, kh.to(card), kl.to(card))
    mxu = ops.sketch_estimate_mxu(fused, kh[:500].to(card), kl[:500].to(card))
    dense = sketch.tensor_sketch_estimate(sk, 3000)
    hb, hs = ops.hash_points(params.to(card), grid, pts.to(card), 12)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"sketch_update_table": 2,
                              "sketch_estimate_table": 3, "hash_points": 1}
    assert float(dev.table.abs().sum()) == 0.0     # update copies
    cpu = sketch.update(sk0, kh, kl)
    assert torch.equal(sk.table.cpu(), cpu.table)
    assert torch.equal(fused.table.cpu(), cpu.table)
    want = sketch.estimate(cpu, kh[:500], kl[:500])
    _same_bits(est, want)
    _same_bits(mxu, want)
    _same_bits(dense, sketch.tensor_sketch_estimate(cpu, 3000))
    wb, ws = hashing.hashes(params, kh, kl, 12)
    assert torch.equal(hb.cpu(), wb) and torch.equal(hs.cpu(), ws)


@pytest.mark.cuda
def test_sketch_kernel_wrappers_reject_bad_inputs(card):
    before = LAUNCHES["sketch_estimate_table"]
    params = _params(4, 0).to(card)
    grid, pts = _hash_case(10, 3, 8, 0)
    pts = pts.to(card)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hp_mod.hash_points_cuda(params, grid, pts.cpu(), 8)
    with pytest.raises(ValueError, match="float32"):
        hp_mod.hash_points_cuda(params, grid, pts.double(), 8)
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        hp_mod.hash_points_cuda(params, grid, pts[:, :2].contiguous(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        hp_mod.hash_points_cuda(params, grid, pts.T.contiguous().T, 8)
    with pytest.raises(ValueError, match="hash params"):
        hp_mod.hash_points_cuda(_params(4, 0), grid, pts, 8)
    table = torch.zeros((4, 256), device=card)
    k = torch.zeros(5, dtype=torch.int64, device=card)
    v = torch.ones(5, device=card)
    with pytest.raises(ValueError, match="CUDA tensors"):
        su_mod.sketch_update_cuda(table.cpu(), params, k, k, v)
    with pytest.raises(ValueError, match="float32"):
        su_mod.sketch_update_cuda(table.double(), params, k, k, v)
    with pytest.raises(ValueError, match="int64"):
        su_mod.sketch_update_cuda(table, params, k.int(), k, v)
    with pytest.raises(ValueError, match="power-of-two"):
        su_mod.sketch_update_cuda(table[:, :100], params, k, k, v)
    with pytest.raises(ValueError, match="need table"):
        su_mod.sketch_update_cuda(table[:3], params, k, k, v)
    with pytest.raises(ValueError, match="contiguous"):
        su_mod.sketch_update_cuda(table, params, k, k,
                                  torch.ones(10, device=card)[::2])
    strided = params._replace(a1_hi=torch.zeros(
        8, dtype=torch.int64, device=card)[::2])
    with pytest.raises(ValueError, match="hash params"):
        su_mod.sketch_update_cuda(table, strided, k, k, v)
    with pytest.raises(ValueError, match="hash params"):
        hp_mod.hash_points_cuda(params._replace(b_lo=params.b_lo.int()),
                                grid, pts, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        se_mod.estimate_cuda(table, params, k.cpu(), k)
    with pytest.raises(ValueError, match="CUDA tensors"):
        se_mod.estimate_range_cuda(table.cpu(), params, 0, v)
    with pytest.raises(ValueError, match="int64"):
        se_mod.estimate_cuda(table, params, k.int(), k)
    with pytest.raises(ValueError, match="float32"):
        se_mod.estimate_cuda(table.double(), params, k, k)
    with pytest.raises(ValueError, match="float32"):
        se_mod.estimate_range_cuda(table, params, 0, v.double())
    with pytest.raises(ValueError, match="need table"):
        se_mod.estimate_cuda(table[:3], params, k, k)
    with pytest.raises(ValueError, match="power-of-two"):
        se_mod.estimate_cuda(table[:, :100].contiguous(), params, k, k)
    with pytest.raises(ValueError, match="contiguous"):
        se_mod.estimate_cuda(table[:, ::2], params, k, k)
    with pytest.raises(ValueError, match="contiguous"):
        se_mod.estimate_range_cuda(table, params, 0,
                                   torch.ones(10, device=card)[::2])
    with pytest.raises(ValueError, match="need keys"):
        se_mod.estimate_cuda(table, params, k[None], k[None])
    with pytest.raises(ValueError, match="hash params"):
        se_mod.estimate_cuda(table, strided, k, k)
    with pytest.raises(ValueError, match="2\\^32"):
        se_mod.estimate_range_cuda(table, params, (1 << 32) - 4, v)
    assert LAUNCHES["sketch_estimate_table"] == before

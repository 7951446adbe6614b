"""Parity of the port's representatives (repro_torch.core.replicas) with
the JAX reference: live mask, weights and ids identical; points within
1 ulp given the same jitter (the cell-center sum may be fused into an FMA
on one side and not the other)."""
import jax
import numpy as np
import pytest
import torch

import _torch_parity as par
from repro.core import replicas as ref_replicas
from repro_torch.core import prng, quantize, replicas


@pytest.mark.parametrize("scheme", ["uniform", "rank", "count"])
def test_replica_counts_identical(scheme):
    _, ref, _, port = par.hh_case(0)
    np.testing.assert_array_equal(
        np.asarray(ref_replicas.replica_counts(ref, scheme, 8)),
        replicas.replica_counts(port, scheme, 8).numpy())


@pytest.mark.parametrize("scheme,max_replicas", [("count", 8), ("rank", 3)])
def test_representatives_match_given_jitter(scheme, max_replicas):
    grid, ref, tgrid, port = par.hh_case(1)
    seed = 4
    rr = ref_replicas.make_representatives(
        jax.random.split(jax.random.key(seed + 1))[0],
        grid, ref, scheme=scheme, max_replicas=max_replicas)
    jit = par.replica_jitter(seed, ref.key_hi, ref.key_lo, max_replicas,
                             grid.dims, 0.25)
    tr = replicas.make_representatives(tgrid, port, scheme=scheme,
                                       max_replicas=max_replicas,
                                       jitter=torch.from_numpy(jit))
    np.testing.assert_array_equal(np.asarray(rr.mask), tr.mask.numpy())
    np.testing.assert_array_equal(np.asarray(rr.weight), tr.weight.numpy())
    np.testing.assert_array_equal(np.asarray(rr.hh_id), tr.hh_id.numpy())
    rp, tp = np.asarray(rr.points), tr.points.numpy()
    assert np.all(np.abs(rp - tp) <= np.spacing(np.abs(rp)))
    pts, w, ids = replicas.compact(tr)
    rpts, rw, rids = ref_replicas.compact(rr)
    assert pts.shape == rpts.shape
    np.testing.assert_array_equal(rw, w.numpy())
    np.testing.assert_array_equal(rids, ids.numpy())


def test_generator_jitter_stays_inside_the_cell():
    _, _, tgrid, port = par.hh_case(2)
    reps = replicas.make_representatives(tgrid, port, key=prng.key(0),
                                         jitter_frac=0.25)
    centers = quantize.cell_center(tgrid, quantize.unpack(
        tgrid, (port.key_hi, port.key_lo)))
    off = reps.points.reshape(centers.shape[0], 8, -1) - centers[:, None]
    cell = torch.as_tensor(tgrid.cell_size)
    assert bool((off.abs() <= 0.25 * cell * (1 + 1e-5)).all())
    with pytest.raises(ValueError, match="jitter must have shape"):
        replicas.make_representatives(tgrid, port,
                                      jitter=torch.zeros(3, 8, 4))
    with pytest.raises(ValueError, match="threefry key"):
        replicas.make_representatives(tgrid, port)

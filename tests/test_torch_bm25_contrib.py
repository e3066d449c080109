"""The port's gather + BM25 contribution (elasticsearch_tpu_torch/ops/
bm25_contrib.py) against the reference's scoring expression
(``ops/bm25.py bm25_contrib``, gathered as ``ops/fastpath.py gather_one``
does) and its Pallas kernel (``bm25_contrib_pallas``, interpret mode),
with the reserved zero block in the selection and dead docs in the mask
rows. On a CPU tensor the port runs its plain twin."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops.bm25 import bm25_contrib as jax_bm25_contrib
from elasticsearch_tpu.ops.pallas_bm25 import bm25_contrib_pallas
from elasticsearch_tpu_torch.ops.bm25 import _SENTINEL
from elasticsearch_tpu_torch.ops.bm25_contrib import (
    gather_bm25_contrib, gather_bm25_contrib_plain)

K1, B = 1.2, 0.75


def make_cohort(seed, q=3, nb=16, tb=40, nd=3000, f=4):
    rng = np.random.default_rng(seed)
    bd = np.zeros((tb + 1, 128), np.int32)        # + reserved zero block
    bt = np.zeros((tb + 1, 128), np.float32)
    for i in range(tb):
        fill = int(rng.integers(1, 129))
        bd[i, :fill] = np.sort(rng.choice(nd, fill, replace=False))
        bt[i, :fill] = rng.integers(1, 9, fill)
    lens = rng.integers(3, 90, nd).astype(np.float32)
    sel = rng.integers(0, tb, (q, nb)).astype(np.int32)
    sel[:, -3:] = tb                              # padding: the zero block
    ws = (rng.random((q, nb)) * 5 + 0.1).astype(np.float32)
    ws[:, -3:] = 0.0
    masks = np.ones((f, nd), bool)
    masks[1:] = rng.random((f - 1, nd)) < 0.7     # dead docs in rows 1..
    mids = rng.integers(0, f, q).astype(np.int32)
    avg = np.float32(lens.mean())
    return bd, bt, sel, ws, lens, masks, mids, avg


def port(bd, bt, sel, ws, lens, masks, mids, avg):
    keys, con = gather_bm25_contrib(*map(torch.from_numpy,
                                         (bd, bt, sel, ws, lens, masks,
                                          mids)), float(avg), K1, B)
    return keys.numpy(), con.numpy()


def reference(bd, bt, sel, ws, lens, masks, mids, avg, contrib_fn):
    """The reference's gather_one, one query row at a time."""
    keys, cons = [], []
    for s, w, mid in zip(sel, ws, mids):
        d = bd[s]
        tf = bt[s]
        dl = lens[d]
        c = np.asarray(contrib_fn(w, tf, dl))
        c = np.where((tf > 0) & masks[mid][d], c, 0.0)
        keys.append(np.where(tf > 0, d, _SENTINEL).reshape(-1))
        cons.append(c.reshape(-1))
    return np.stack(keys), np.stack(cons)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_contrib_matches_reference_expression(seed):
    args = make_cohort(seed)
    avg = args[-1]
    keys, con = port(*args)
    rk, rc = reference(*args, lambda w, tf, dl: jax_bm25_contrib(
        jnp.asarray(w), jnp.asarray(tf), jnp.asarray(dl),
        jnp.float32(avg), K1, B))
    np.testing.assert_array_equal(keys, rk)
    assert con.dtype == np.float32
    np.testing.assert_allclose(con, rc, rtol=2e-7, atol=0)
    assert (con[keys == _SENTINEL] == 0).all()


@pytest.mark.parametrize("seed", [3, 4])
def test_contrib_matches_pallas_kernel(seed):
    args = make_cohort(seed)
    avg = args[-1]
    keys, con = port(*args)
    # the Pallas kernel tiles [NB, 128] planes; nb=16 is one tile
    rk, rc = reference(*args, lambda w, tf, dl: bm25_contrib_pallas(
        jnp.asarray(w), jnp.asarray(tf), jnp.asarray(dl), avg, K1, B))
    np.testing.assert_array_equal(keys, rk)
    np.testing.assert_allclose(con, rc, rtol=1e-6, atol=0)


def test_contrib_f64_rail_matches_numpy():
    bd, bt, sel, ws, lens, masks, mids, avg = make_cohort(5)
    ws64 = ws.astype(np.float64)
    avg64 = float(lens.astype(np.float64).mean())
    keys, con = gather_bm25_contrib(*map(torch.from_numpy, (
        bd, bt, sel, ws64, lens, masks, mids)), avg64, K1, B)
    assert con.dtype == torch.float64
    _, rc = reference(bd, bt, sel, ws64, lens, masks, mids, avg64,
                      lambda w, tf, dl: w[:, None] * np.where(
                          tf > 0, tf / (tf + K1 * (1 - B + B * dl.astype(
                              np.float64) / avg64)), 0.0))
    np.testing.assert_allclose(con.numpy(), rc, rtol=1e-12, atol=0)


def test_twin_is_what_the_wrapper_runs_on_cpu():
    args = make_cohort(6)
    t = list(map(torch.from_numpy, args[:-1]))
    before = gather_bm25_contrib.launches
    k1, c1 = gather_bm25_contrib(*t, float(args[-1]), K1, B)
    k2, c2 = gather_bm25_contrib_plain(*t, float(args[-1]), K1, B)
    assert torch.equal(k1, k2) and torch.equal(c1, c2)
    assert gather_bm25_contrib.launches == before   # no kernel on the CPU


@pytest.mark.parametrize("bad", ["dtype", "weights", "mask_ids", "masks",
                                 "blocks"])
def test_contrib_wrapper_checks(bad):
    bd, bt, sel, ws, lens, masks, mids, avg = make_cohort(7)
    t = dict(zip(["bd", "bt", "sel", "ws", "lens", "masks", "mids"],
                 map(torch.from_numpy, (bd, bt, sel, ws, lens, masks,
                                        mids))))
    if bad == "dtype":
        t["sel"] = t["sel"].to(torch.int64)
    elif bad == "weights":
        t["ws"] = t["ws"].to(torch.float16)
    elif bad == "mask_ids":
        t["mids"] = t["mids"][:1]
    elif bad == "masks":
        t["masks"] = t["masks"][:, :10]
    else:
        t["bd"] = t["bd"][:, :64]
        t["bt"] = t["bt"][:, :64]
    with pytest.raises((ValueError, TypeError)):
        gather_bm25_contrib(*t.values(), float(avg), K1, B)

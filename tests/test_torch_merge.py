"""The port's merge (elasticsearch_tpu_torch/ops/merge.py) against the
reference's ``merge_sorted_slots``: the Pallas network in interpret mode
(keys exact, (key, payload) multiset equal) and the CPU shortcut
``lax.sort`` (keys and payload exact). On a CPU tensor the port runs its
plain twin, the stable sort the CUDA kernel is held to on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops.merge import merge_sorted_slots as jax_merge
from elasticsearch_tpu_torch.ops.bm25 import _SENTINEL
from elasticsearch_tpu_torch.ops.merge import (merge_sorted_slots,
                                               merge_sorted_slots_plain)


def make_inputs(q, p, n_slots, seed, n_docs=100_000, empty_slots=()):
    """Per-slot ascending docids with sentinel padding; the payload is
    the lane index (int32), as on the serving path."""
    rng = np.random.default_rng(seed)
    length = p // n_slots
    keys = np.full((q, n_slots, length), _SENTINEL, np.int32)
    for qi in range(q):
        for s in range(n_slots):
            if s in empty_slots:
                continue
            fill = int(rng.integers(0, length + 1))
            keys[qi, s, :fill] = np.sort(
                rng.choice(n_docs, size=fill, replace=False))
    lane = np.broadcast_to(np.arange(p, dtype=np.int32),
                           (q, p)).reshape(q, n_slots, length).copy()
    return keys, lane


def port_merge(keys, vals):
    mk, mv = merge_sorted_slots(torch.from_numpy(keys),
                                torch.from_numpy(vals))
    return mk.numpy(), mv.numpy()


# the parameter cases of tests/test_merge.py, plus all-sentinel slots
CASES = [
    (2, 1 << 11, 1 << 10, ()),
    (4, 1 << 12, 1 << 10, ()),
    (8, 1 << 13, 1 << 11, ()),
    (16, 1 << 14, 1 << 12, ()),
    (8, 1 << 13, 1 << 13, ()),
    (8, 1 << 13, 1 << 9, ()),
    (8, 1 << 11, 1 << 9, (0, 3, 4, 7)),
    (4, 1 << 11, 1 << 10, (0, 1, 2, 3)),
]


@pytest.mark.parametrize("n_slots,p,chunk,empty", CASES)
def test_merge_matches_pallas_network(n_slots, p, chunk, empty):
    keys, lane = make_inputs(1, p, n_slots, seed=n_slots + p,
                             empty_slots=empty)
    # eager, not jitted: the reference's interpret-mode network
    jk, jv = jax_merge(jnp.asarray(keys), jnp.asarray(lane), chunk=chunk,
                       force_pallas=True)
    jk, jv = np.asarray(jk), np.asarray(jv)
    mk, mv = port_merge(keys, lane)
    np.testing.assert_array_equal(mk, jk)
    assert sorted(zip(mk[0].tolist(), mv[0].tolist())) == \
        sorted(zip(jk[0].tolist(), jv[0].tolist()))
    # with a unique ascending payload the port's order is the stable one
    flat = keys.reshape(1, p)
    np.testing.assert_array_equal(mv[0], np.argsort(flat[0], kind="stable"))


@pytest.mark.parametrize("n_slots,p,chunk,empty", CASES)
def test_merge_matches_reference_shortcut(n_slots, p, chunk, empty):
    keys, lane = make_inputs(3, p, n_slots, seed=7 * n_slots + p,
                             empty_slots=empty)
    jk, jv = jax_merge(jnp.asarray(keys), jnp.asarray(lane))  # lax.sort
    mk, mv = port_merge(keys, lane)
    np.testing.assert_array_equal(mk, np.asarray(jk))
    np.testing.assert_array_equal(mv, np.asarray(jv))


def test_merge_carries_float_payload():
    """The twin carries any payload dtype through the permutation."""
    keys, lane = make_inputs(2, 1 << 10, 4, seed=5)
    vals = (lane.astype(np.float64) * 0.5 + 0.25)
    mk, mv = merge_sorted_slots(torch.from_numpy(keys),
                                torch.from_numpy(vals))
    _, ml = port_merge(keys, lane)
    np.testing.assert_array_equal(mv.numpy(), ml * 0.5 + 0.25)
    np.testing.assert_array_equal(
        mk.numpy(), np.sort(keys.reshape(2, -1), axis=1))


def test_merge_twin_is_the_stable_sort():
    keys, lane = make_inputs(2, 1 << 9, 2, seed=9, n_docs=300)
    sk, sv = merge_sorted_slots_plain(torch.from_numpy(keys),
                                      torch.from_numpy(lane))
    flat = keys.reshape(2, -1)
    for q in range(2):
        order = np.argsort(flat[q], kind="stable")
        np.testing.assert_array_equal(sk[q].numpy(), flat[q][order])
        np.testing.assert_array_equal(sv[q].numpy(), order)


@pytest.mark.parametrize("bad", ["shape", "dtype", "pow2", "device"])
def test_merge_wrapper_checks(bad):
    keys, lane = make_inputs(1, 1 << 9, 4, seed=1)
    k, v = torch.from_numpy(keys), torch.from_numpy(lane)
    if bad == "shape":
        k = k.reshape(1, -1)
    elif bad == "dtype":
        k = k.to(torch.int64)
    elif bad == "pow2":
        k, v = k[:, :3], v[:, :3]
    else:
        v = v.to("meta")
    with pytest.raises((ValueError, TypeError)):
        merge_sorted_slots(k, v)

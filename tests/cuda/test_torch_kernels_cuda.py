"""The port's two CUDA kernels against their plain PyTorch twins on the
card, at shapes the serving path does not reach (a query row shorter than
one shared-memory chunk, two slots, one slot, a single query) as well as
one of its own, and the whole cohort launch on the card against the same
launch on the CPU."""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ops.bm25 import _SENTINEL
from elasticsearch_tpu_torch.ops.bm25_contrib import (
    gather_bm25_contrib, gather_bm25_contrib_plain)
from elasticsearch_tpu_torch.ops.fastpath import (
    F_SLOTS, bm25_topk_total_merge_batch)
from elasticsearch_tpu_torch.ops.merge import (merge_sorted_slots,
                                               merge_sorted_slots_plain)

pytestmark = pytest.mark.cuda

K1, B = 1.2, 0.75


def sorted_slots(q, n_slots, length, seed):
    """Per-slot ascending docids with sentinel padding (one slot empty);
    the lane index as payload, as on the serving path."""
    rng = np.random.default_rng(seed)
    keys = np.full((q, n_slots, length), _SENTINEL, np.int32)
    for qi in range(q):
        for s in range(n_slots):
            if n_slots > 1 and s == 1:
                continue
            fill = int(rng.integers(0, length + 1))
            keys[qi, s, :fill] = np.sort(rng.integers(0, 3 * length, fill))
    lane = np.broadcast_to(np.arange(n_slots * length, dtype=np.int32),
                           (q, n_slots * length)).reshape(keys.shape).copy()
    return torch.from_numpy(keys), torch.from_numpy(lane)


@pytest.mark.parametrize("q,n_slots,length", [
    (1, 2, 8), (3, 4, 256), (2, 16, 1024), (1, 1, 64), (2, 2, 1 << 14),
    (2, 16, 1 << 15)])
def test_merge_kernel_equals_twin(cuda_device, q, n_slots, length):
    keys, lane = sorted_slots(q, n_slots, length, seed=q * n_slots + length)
    pk, pv = merge_sorted_slots_plain(keys, lane)
    before = merge_sorted_slots.launches
    mk, mv = merge_sorted_slots(keys.to(cuda_device), lane.to(cuda_device))
    assert merge_sorted_slots.launches == before + 1
    assert torch.equal(mk.cpu(), pk) and torch.equal(mv.cpu(), pv)


def test_merge_kernel_refuses_bad_input(cuda_device):
    keys, lane = sorted_slots(2, 4, 64, seed=1)
    k, v = keys.to(cuda_device), lane.to(cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        merge_sorted_slots(k.transpose(1, 2).contiguous().transpose(1, 2),
                           v)
    with pytest.raises(TypeError, match="int32 payload"):
        merge_sorted_slots(k, v.to(torch.int64))


def contrib_inputs(device, dtype, seed, q=3, nb=16, tb=40, nd=4096):
    """Random blocks plus the reserved zero block at index ``tb``, a
    selection that uses it, and a mask row with dead docs."""
    rng = np.random.default_rng(seed)
    docids = np.sort(rng.integers(0, nd, (tb + 1, 128)), axis=1)
    tfs = rng.integers(0, 5, (tb + 1, 128)).astype(np.float32)
    docids[tb], tfs[tb] = 0, 0.0
    sel = rng.integers(0, tb + 1, (q, nb)).astype(np.int32)
    sel[:, -2:] = tb
    ws = rng.random((q, nb)) * 3.0
    lens = rng.integers(1, 60, nd).astype(np.float32)
    masks = np.ones((F_SLOTS, nd), bool)
    masks[1] = rng.random(nd) < 0.7
    mids = (np.arange(q) % 2).astype(np.int32)
    avg = float(torch.tensor(float(lens.mean()), dtype=dtype))
    t = torch.from_numpy
    return (t(docids.astype(np.int32)).to(device), t(tfs).to(device),
            t(sel).to(device), t(ws).to(dtype).to(device), t(lens).to(device),
            t(masks).to(device), t(mids).to(device), avg, K1, B)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 2e-7)])
def test_contrib_kernel_equals_twin(cuda_device, dtype, rtol):
    args = contrib_inputs(cuda_device, dtype, seed=3)
    before = gather_bm25_contrib.launches
    keys, con = gather_bm25_contrib(*args)
    assert gather_bm25_contrib.launches == before + 1
    pkeys, pcon = gather_bm25_contrib_plain(*args)
    assert torch.equal(keys, pkeys)
    assert con.dtype == dtype and bool((keys == _SENTINEL).any())
    torch.testing.assert_close(con, pcon, rtol=rtol, atol=0)


def test_cohort_launch_on_card_equals_cpu(cuda_device):
    """The whole v2m cohort launch (both kernels plus the PyTorch scan,
    run-last selection and top-k) on the card against the same launch
    on the CPU, where the wrappers run their twins."""
    rng = np.random.default_rng(11)
    nd, tb, q, nb, n_slots, k = 8192, 96, 4, 64, 16, 40
    docids = np.zeros((tb + 1, 128), np.int32)
    tfs = np.zeros((tb + 1, 128), np.float32)
    for i in range(tb):
        fill = int(rng.integers(1, 129))
        docids[i, :fill] = np.sort(rng.choice(nd, fill, replace=False))
        tfs[i, :fill] = rng.integers(1, 6, fill)
    slot = nb // n_slots
    sel = np.full((q, nb), tb, np.int32)
    ws = np.zeros((q, nb))
    for qi in range(q):
        for s in range(n_slots):
            if rng.random() < 0.6:
                sel[qi, s * slot] = rng.integers(0, tb)
                ws[qi, s * slot] = rng.random() * 4
    lens = rng.integers(1, 50, nd).astype(np.float32)
    masks = np.ones((F_SLOTS, nd), bool)
    masks[1] = rng.random(nd) < 0.8
    mids = np.array([0, 1, 0, 1], np.int32)

    def run(dev):
        t = torch.from_numpy
        return bm25_topk_total_merge_batch(
            t(docids).to(dev), t(tfs).to(dev), t(sel).to(dev),
            t(ws).to(dev), t(lens).to(dev), t(masks).to(dev),
            t(mids).to(dev), float(lens.mean()), n_slots, K1, B, k,
            score_dtype=torch.float64).cpu().numpy()

    got, want = run(cuda_device), run(torch.device("cpu"))
    np.testing.assert_array_equal(got[:, k:], want[:, k:])
    np.testing.assert_allclose(got[:, :k], want[:, :k], rtol=1e-7, atol=0)

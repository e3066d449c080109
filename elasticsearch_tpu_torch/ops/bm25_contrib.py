"""Kernel 1: gather + BM25 contribution for a v2m cohort.

Counterpart of elasticsearch_tpu/ops/pallas_bm25.py (`_contrib_kernel`,
`bm25_contrib_pallas`) fused with the gather of ops/fastpath.py
`gather_one`. The CUDA kernel is ``csrc/bm25_contrib.cu``; this module
holds its wrapper and its plain PyTorch twin.

For one cohort of Q queries, each with NB selected postings blocks:

    keys    [Q, NB*128] int32   docid where tf > 0, else _SENTINEL
    contrib [Q, NB*128] rail    w * tf / (tf + k1*(1 - b + b*dl/avg)) where
                                tf > 0 and the doc is live in the query's
                                mask row, else 0

A CPU tensor takes the twin. A CUDA tensor launches the kernel or
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from elasticsearch_tpu_torch.ops.bm25 import _SENTINEL, bm25_contrib
from elasticsearch_tpu_torch.telemetry.engine import tracked_kernel

_B = 128  # index/segment.py BLOCK_SIZE


def _check(block_docids, block_tfs, sel_blocks, sel_weights, doc_lens,
           masks, mask_ids):
    dev = sel_blocks.device
    named = dict(block_docids=block_docids, block_tfs=block_tfs,
                 sel_blocks=sel_blocks, sel_weights=sel_weights,
                 doc_lens=doc_lens, masks=masks, mask_ids=mask_ids)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, sel_blocks on {dev}")
    want = dict(block_docids=torch.int32, block_tfs=torch.float32,
                sel_blocks=torch.int32, doc_lens=torch.float32,
                masks=torch.bool, mask_ids=torch.int32)
    for name, dt in want.items():
        if named[name].dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {named[name].dtype}")
    if sel_weights.dtype not in (torch.float32, torch.float64):
        raise TypeError("sel_weights must be float32 or float64 (the rail "
                        f"dtype), got {sel_weights.dtype}")
    if block_docids.dim() != 2 or block_docids.shape[1] != _B \
            or block_tfs.shape != block_docids.shape:
        raise ValueError("block_docids/block_tfs must be [TB, 128], got "
                         f"{tuple(block_docids.shape)} / "
                         f"{tuple(block_tfs.shape)}")
    if sel_blocks.dim() != 2 or sel_weights.shape != sel_blocks.shape:
        raise ValueError("sel_blocks/sel_weights must be [Q, NB], got "
                         f"{tuple(sel_blocks.shape)} / "
                         f"{tuple(sel_weights.shape)}")
    if doc_lens.dim() != 1 or masks.dim() != 2 \
            or masks.shape[1] != doc_lens.shape[0]:
        raise ValueError("masks must be [F, ND] over doc_lens [ND], got "
                         f"{tuple(masks.shape)} / {tuple(doc_lens.shape)}")
    if mask_ids.shape != (sel_blocks.shape[0],):
        raise ValueError(f"mask_ids must be [Q], got {tuple(mask_ids.shape)}")


def gather_bm25_contrib_plain(block_docids, block_tfs, sel_blocks,
                              sel_weights, doc_lens, masks, mask_ids,
                              avg: float, k1: float, b: float):
    """The plain PyTorch twin: the same function on any device."""
    dt = sel_weights.dtype
    q = sel_blocks.shape[0]
    d = block_docids[sel_blocks.long()]                    # [Q, NB, B]
    tf = block_tfs[sel_blocks.long()].to(dt)
    dl = doc_lens[d.long()].to(dt)
    # a fill on the device, not a host copy: the twin never syncs
    avg_t = torch.full((), avg, dtype=dt, device=sel_weights.device)
    contrib = bm25_contrib(sel_weights, tf, dl, avg_t, k1, b)
    live = masks[mask_ids.long()[:, None, None], d.long()]
    valid = tf > 0.0
    contrib = torch.where(valid & live, contrib, 0.0)
    keys = torch.where(valid, d, _SENTINEL)
    return keys.reshape(q, -1), contrib.reshape(q, -1)


@tracked_kernel("gather_bm25_contrib")
def gather_bm25_contrib(block_docids, block_tfs, sel_blocks, sel_weights,
                        doc_lens, masks, mask_ids, avg: float, k1: float,
                        b: float):
    """(keys [Q, NB*128] int32, contrib [Q, NB*128] rail dtype).

    ``avg`` is the mean field length already rounded to the rail dtype
    (``sel_weights.dtype``). Inputs are contiguous; every selected block
    id is < TB and every mask id < F (the callers build both on the
    host and check them there)."""
    _check(block_docids, block_tfs, sel_blocks, sel_weights, doc_lens,
           masks, mask_ids)
    if sel_blocks.device.type == "cpu":
        return gather_bm25_contrib_plain(block_docids, block_tfs,
                                         sel_blocks, sel_weights, doc_lens,
                                         masks, mask_ids, avg, k1, b)
    for name, t in (("block_docids", block_docids), ("block_tfs", block_tfs),
                    ("sel_blocks", sel_blocks), ("sel_weights", sel_weights),
                    ("doc_lens", doc_lens), ("masks", masks),
                    ("mask_ids", mask_ids)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from elasticsearch_tpu_torch.ops._build import library
    lib = library("bm25_contrib")
    f64 = sel_weights.dtype == torch.float64
    fn = lib.gather_bm25_contrib_f64 if f64 else \
        lib.gather_bm25_contrib_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64] * 3
                       + [ctypes.c_double] * 4 + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
    q, nb = sel_blocks.shape
    keys = torch.empty((q, nb * _B), dtype=torch.int32,
                       device=sel_blocks.device)
    contrib = torch.empty((q, nb * _B), dtype=sel_weights.dtype,
                          device=sel_blocks.device)
    with torch.cuda.device(sel_blocks.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(block_docids.data_ptr(), block_tfs.data_ptr(),
                sel_blocks.data_ptr(), sel_weights.data_ptr(),
                doc_lens.data_ptr(), masks.data_ptr(), mask_ids.data_ptr(),
                q, nb, doc_lens.shape[0], float(avg), float(k1), float(b),
                1.0 - float(b), keys.data_ptr(), contrib.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"gather_bm25_contrib kernel launch failed: "
                           f"CUDA error {rc}")
    gather_bm25_contrib.launches += 1
    return keys, contrib


gather_bm25_contrib.launches = 0

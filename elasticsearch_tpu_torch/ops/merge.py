"""Kernel 2: merge of per-term docid-sorted runs into one sorted cohort row.

Counterpart of elasticsearch_tpu/ops/merge.py `merge_sorted_slots` (its
Pallas `_chunk_kernel` and XLA `_xla_stage` rounds). The CUDA kernel is
``csrc/merge.cu``, a merge-path merge of log2(n_slots) rounds; this module
holds its wrapper and its plain PyTorch twin.

Contract: keys [Q, n_slots, L] int32, each slot ascending (sentinel
padding last), with an int32 payload of the same shape. Out: ([Q, P],
[Q, P]) with keys ascending, P = n_slots * L. Ties order by payload, so
with the lane index as payload (the serving path) the result is exactly
the stable sort by key, which is what the twin computes.
"""

from __future__ import annotations

import ctypes

import torch

from elasticsearch_tpu_torch.telemetry.engine import tracked_kernel


def merge_sorted_slots_plain(keys: torch.Tensor, vals: torch.Tensor):
    """The plain PyTorch twin: stable sort by key, payload carried."""
    q, n_slots, slot_len = keys.shape
    p = n_slots * slot_len
    sk, idx = torch.sort(keys.reshape(q, p), dim=1, stable=True)
    return sk, torch.gather(vals.reshape(q, p), 1, idx)


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


@tracked_kernel("merge_sorted_slots")
def merge_sorted_slots(keys: torch.Tensor, vals: torch.Tensor):
    """Merge [Q, n_slots, L] per-slot ascending runs -> ([Q, P], [Q, P])
    ascending by (key, payload). ``n_slots`` and ``L`` are powers of two;
    on CUDA both tensors are contiguous int32."""
    if keys.dim() != 3 or vals.shape != keys.shape:
        raise ValueError("keys/vals must both be [Q, n_slots, L], got "
                         f"{tuple(keys.shape)} / {tuple(vals.shape)}")
    if keys.device != vals.device:
        raise ValueError(f"keys on {keys.device}, vals on {vals.device}")
    if keys.dtype != torch.int32:
        raise TypeError(f"keys must be int32, got {keys.dtype}")
    q, n_slots, slot_len = keys.shape
    if not (_is_pow2(n_slots) and _is_pow2(slot_len)):
        raise ValueError(f"n_slots ({n_slots}) and slot length "
                         f"({slot_len}) must be powers of two")
    if keys.device.type == "cpu":
        return merge_sorted_slots_plain(keys, vals)
    if vals.dtype != torch.int32:
        raise TypeError(f"the merge kernel carries an int32 payload, got "
                        f"{vals.dtype}")
    if not (keys.is_contiguous() and vals.is_contiguous()):
        raise ValueError("keys and vals must be contiguous")
    from elasticsearch_tpu_torch.ops._build import library
    fn = library("merge").merge_sorted_slots_i32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    p = n_slots * slot_len
    mk = torch.empty((q, p), dtype=torch.int32, device=keys.device)
    mv = torch.empty((q, p), dtype=torch.int32, device=keys.device)
    # from four slots on, the rounds alternate between a scratch pair and
    # the output
    tk = tv = None
    if n_slots >= 4:
        tk, tv = torch.empty_like(mk), torch.empty_like(mv)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(keys.data_ptr(), vals.data_ptr(), mk.data_ptr(),
                mv.data_ptr(), tk.data_ptr() if tk is not None else None,
                tv.data_ptr() if tv is not None else None, q, n_slots,
                slot_len, stream)
    if rc != 0:
        raise RuntimeError(f"merge_sorted_slots kernel launch failed: "
                           f"CUDA error {rc}")
    merge_sorted_slots.launches += 1
    return mk, mv


merge_sorted_slots.launches = 0

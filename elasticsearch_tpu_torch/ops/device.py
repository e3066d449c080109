"""Device-resident segment state (counterpart of elasticsearch_tpu/ops/device.py).

A DeviceSegment uploads a segment's postings blocks, doc lengths and
live mask to the device once; every query then ships only its block ids
and weights.

Shape discipline:
- the doc count pads to a multiple of ``DOC_PAD`` (padded docs are dead
  in the live mask and have doc_len = avg, so no NaN or 0-division);
- one reserved all-zeros postings block sits at index ``num_blocks``:
  query block lists pad with it (weight 0).
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import Dict

import numpy as np
import torch

from elasticsearch_tpu_torch.device import DeviceLike, resolve_device
from elasticsearch_tpu_torch.index.segment import BLOCK_SIZE, Segment
from elasticsearch_tpu_torch.ops.plan import check_packed_id_limit

DOC_PAD = 1024

# device -> host copies per call site (see readback)
READBACKS: Counter = Counter()
_readback_lock = threading.Lock()


def readback(site: str, *tensors: torch.Tensor):
    """THE device-to-host funnel of the serving path: every transfer of
    a kernel's output to host memory goes through here and counts under
    its stable dotted ``site`` label in ``READBACKS``. Returns the numpy
    array for one input, a tuple for several."""
    out = tuple(t.cpu().numpy() for t in tensors)
    with _readback_lock:
        READBACKS[site] += 1
    return out[0] if len(out) == 1 else out


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class DevicePostings:
    """One field's postings on the device, with the reserved zero block."""

    def __init__(self, pf, n_docs_padded: int, device: torch.device):
        tb = pf.block_docids.shape[0]
        docids = np.concatenate(
            [pf.block_docids, np.zeros((1, BLOCK_SIZE), np.int32)], axis=0)
        tfs = np.concatenate(
            [pf.block_tfs, np.zeros((1, BLOCK_SIZE), np.float32)], axis=0)
        self.block_docids = torch.from_numpy(docids).to(device)
        self.block_tfs = torch.from_numpy(tfs).to(device)
        lens = np.zeros(n_docs_padded, np.float32)
        lens[: len(pf.field_lengths)] = pf.field_lengths
        avg = pf.avg_field_length
        lens[len(pf.field_lengths):] = avg  # padded docs: harmless norm
        self.doc_lens = torch.from_numpy(lens).to(device)
        self.zero_block = tb  # index of the reserved all-zeros block
        self.avg_len = float(avg)
        # the term dictionary stays on the host
        self.term_block_start = pf.term_block_start
        self.term_block_count = pf.term_block_count
        self.doc_freq = pf.doc_freq
        self.host = pf


class DeviceSegment:
    """A segment resident in device memory, built once per (segment,
    device); a refresh swaps whole DeviceSegments."""

    def __init__(self, segment: Segment, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.segment = segment
        self.name = segment.name
        self.n_docs = segment.n_docs
        self.n_docs_padded = max(DOC_PAD, round_up(segment.n_docs, DOC_PAD))
        # docids ride device->host readbacks as float32 casts, exact
        # only < 2^24: enforce at build time, not as wraparound later
        check_packed_id_limit(self.n_docs_padded,
                              f"DeviceSegment[{segment.name}]")
        live = np.zeros(self.n_docs_padded, bool)
        live[: segment.n_docs] = segment.live
        self.live = torch.from_numpy(live).to(self.device)
        self.postings: Dict[str, DevicePostings] = {
            f: DevicePostings(pf, self.n_docs_padded, self.device)
            for f, pf in segment.postings.items()
        }

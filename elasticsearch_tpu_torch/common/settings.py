"""Setting value parsers (counterpart of the jax-free
elasticsearch_tpu/common/settings.py, reduced to what the port reads:
byte sizes, for the ``indices.breaker.*.limit`` settings)."""

from __future__ import annotations

import re
from typing import Any

from elasticsearch_tpu_torch.common.errors import SettingsException

_BYTES_RE = re.compile(r"^(-?\d+(?:\.\d+)?)(b|kb|mb|gb|tb|pb)?$", re.IGNORECASE)
_BYTE_FACTORS = {
    None: 1, "b": 1, "kb": 1024, "mb": 1024 ** 2, "gb": 1024 ** 3,
    "tb": 1024 ** 4, "pb": 1024 ** 5,
}


def parse_byte_size(value: Any, key: str = "") -> int:
    """'512mb' / '1gb' / '100b' -> bytes (int). -1 passes through."""
    if isinstance(value, (int, float)):
        return int(value)
    if str(value).strip() == "-1":
        return -1
    m = _BYTES_RE.match(str(value).strip())
    if not m or float(m.group(1)) < 0:
        raise SettingsException(
            f"failed to parse setting [{key}] with value [{value}] as a byte size"
        )
    unit = m.group(2).lower() if m.group(2) else None
    return int(float(m.group(1)) * _BYTE_FACTORS[unit])

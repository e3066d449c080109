"""Setting value parsers (counterpart of the jax-free
elasticsearch_tpu/common/settings.py, reduced to what the port reads:
byte sizes, for the ``indices.breaker.*.limit`` settings, and bounded
ints, for ``index.number_of_shards``)."""

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


def _flatten(prefix: str, obj: Any, out: dict) -> None:
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, out)
    else:
        out[prefix] = obj


def flat_settings(settings: Any) -> dict:
    """Nested or dotted-key settings (or a mix) as one flat dict of
    dotted keys (the reference's ``Settings.from_dict``)."""
    out: dict = {}
    _flatten("", settings or {}, out)
    return out


def parse_int_setting(flat: dict, key: str, default: int,
                      min_value: int, max_value: int) -> int:
    """An int setting of ``flat`` (``flat_settings``) as the reference's
    ``Setting.int_setting`` reads it: absent gives ``default``, the
    value goes through ``int()``, and a value that does not parse or
    lies outside [min_value, max_value] is a SettingsException with the
    reference's reason."""
    raw = flat.get(key)
    if raw is None:
        return default
    try:
        value = int(raw)
    except (ValueError, TypeError) as e:
        raise SettingsException(
            f"failed to parse setting [{key}] with value [{raw}]: {e}")
    if value < min_value:
        raise SettingsException(f"failed to parse value [{value}] for "
                                f"setting [{key}] must be >= {min_value}")
    if value > max_value:
        raise SettingsException(f"failed to parse value [{value}] for "
                                f"setting [{key}] must be <= {max_value}")
    return value

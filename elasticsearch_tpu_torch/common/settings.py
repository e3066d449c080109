"""Setting value parsers (counterpart of the jax-free
elasticsearch_tpu/common/settings.py, reduced to what the port reads:
byte sizes, for the ``indices.breaker.*.limit`` settings; bounded ints,
for ``index.number_of_shards``; time values, for ``scroll`` and
``keep_alive``; and rollover's looser duration and size conditions,
``parse_ms`` and ``parse_bytes``, the reference's index/metadata.py
``_parse_ms`` and ``_parse_bytes``)."""

from __future__ import annotations

import re
from typing import Any

from elasticsearch_tpu_torch.common.errors import SettingsException

_TIME_RE = re.compile(r"^(-?\d+(?:\.\d+)?)(nanos|micros|ms|s|m|h|d)$")
_TIME_FACTORS = {
    "nanos": 1e-9, "micros": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0,
    "h": 3600.0, "d": 86400.0,
}
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


def parse_time_value(value: Any, key: str = "") -> float:
    """'30s' / '500ms' / '1m' -> seconds (float). -1 passes through; a
    number is seconds."""
    if isinstance(value, (int, float)):
        return float(value)
    if str(value).strip() == "-1":
        return -1.0
    m = _TIME_RE.match(str(value).strip())
    if not m or float(m.group(1)) < 0:
        raise SettingsException(
            f"failed to parse setting [{key}] with value [{value}] as a "
            f"time value")
    return float(m.group(1)) * _TIME_FACTORS[m.group(2)]


def parse_ms(value: Any) -> float:
    """A rollover ``max_age``: milliseconds of '7d', '1h', '30m', '10s',
    '500ms' or a bare number of milliseconds."""
    units = {"ms": 1.0, "s": 1000.0, "m": 60_000.0, "h": 3_600_000.0,
             "d": 86_400_000.0}
    s = str(value)
    for suffix in ("ms", "s", "m", "h", "d"):
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * units[suffix]
    return float(s)


def parse_bytes(value: Any) -> float:
    """A rollover ``max_size``: bytes of '5gb', '10mb', '1kb', '100b' or
    a bare number of bytes."""
    units = {"b": 1, "kb": 1024, "mb": 1024 ** 2, "gb": 1024 ** 3,
             "tb": 1024 ** 4}
    s = str(value).lower()
    for suffix in ("kb", "mb", "gb", "tb", "b"):
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * units[suffix]
    return float(s)

"""Time values of the query DSL (the part of opensearch_tpu.common.settings
the port needs): `parse_time_value` reads a decay function's or a
distance_feature query's `scale`, `offset` and `pivot` on date fields."""

from __future__ import annotations

import re
from typing import Any

from opensearch_tpu_torch.common.errors import SettingsError

_TIME_UNITS = {"nanos": 1e-9, "micros": 1e-6, "ms": 1e-3, "s": 1.0,
               "m": 60.0, "h": 3600.0, "d": 86400.0}


def parse_time_value(value: Any, key: str = "") -> float:
    """'30s' / '5m' / '100ms' / '7d' into seconds (TimeValue's units); a
    bare number is milliseconds."""
    if isinstance(value, (int, float)):
        return float(value) / 1000.0
    text = str(value).strip().lower()
    if text in ("-1", "0"):
        return float(text)
    m = re.fullmatch(r"(-?\d+(?:\.\d+)?)\s*(nanos|micros|ms|s|m|h|d)", text)
    if not m:
        raise SettingsError(f"failed to parse setting [{key}] with value "
                            f"[{value}] as a time value")
    return float(m.group(1)) * _TIME_UNITS[m.group(2)]

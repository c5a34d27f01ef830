"""Typed string-map settings — the single configuration mechanism.

Counterpart of `linevis_tpu/core/settings.py` (a copy: the port imports
nothing of the JAX package).

Reference: `SettingsMap` (`src/Utils/InternalState.hpp:42-126`) — a string
key/value map with typed getters, shared by the GUI, replay scripts and
benchmark states, applied to renderers/data via `setNewSettings`
(`src/Renderers/LineRenderer.hpp:163`). The rebuild keeps exactly this
mechanism (SURVEY §5 config/flag system).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

__all__ = ["SettingsMap"]


class SettingsMap:
    def __init__(self, values: Optional[Dict[str, Any]] = None):
        self._map: Dict[str, str] = {}
        if values:
            for k, v in values.items():
                self.add_key_value(k, v)

    def add_key_value(self, key: str, value: Any) -> None:
        if isinstance(value, bool):
            value = "true" if value else "false"
        self._map[key] = str(value)

    def has_key(self, key: str) -> bool:
        return key in self._map

    def get_value(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._map.get(key, default)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self._map.get(key)
        return default if v is None else int(float(v))

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self._map.get(key)
        return default if v is None else float(v)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self._map.get(key)
        if v is None:
            return default
        return v.strip().lower() in ("true", "1", "yes", "on")

    def get_vec(self, key: str, default: Tuple[float, ...] = ()) -> Tuple[float, ...]:
        v = self._map.get(key)
        if v is None:
            return default
        parts = v.replace("(", " ").replace(")", " ").replace(",", " ").split()
        return tuple(float(p) for p in parts)

    def items(self) -> Iterable[Tuple[str, str]]:
        return self._map.items()

    def update(self, other: "SettingsMap") -> None:
        self._map.update(other._map)

    def copy(self) -> "SettingsMap":
        s = SettingsMap()
        s._map = dict(self._map)
        return s

    def __eq__(self, other) -> bool:
        return isinstance(other, SettingsMap) and self._map == other._map

    def __repr__(self) -> str:
        return f"SettingsMap({self._map!r})"

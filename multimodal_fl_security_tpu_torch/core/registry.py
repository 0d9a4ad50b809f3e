"""Tiny string -> factory registry used by attacks/defenses/models/datasets.

Mirrors the reference's factory functions (reference: src/attacks/__init__.py:31-59,
src/defenses/__init__.py:28-59) with the same registered names, so configs written
for the reference resolve here unchanged.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterable, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Callable[..., T]] = {}

    def register(self, *names: str) -> Callable[[Callable[..., T]], Callable[..., T]]:
        def deco(fn: Callable[..., T]) -> Callable[..., T]:
            for name in names:
                key = name.lower()
                if key in self._entries:
                    raise ValueError(f"duplicate {self.kind} name: {name}")
                self._entries[key] = fn
            return fn

        return deco

    def create(self, name: str, *args, **kwargs) -> T:
        key = (name or "none").lower()
        if key not in self._entries:
            raise ValueError(
                f"unknown {self.kind} '{name}'; available: {sorted(self._entries)}"
            )
        return self._entries[key](*args, **kwargs)

    def names(self) -> Iterable[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return (name or "").lower() in self._entries

"""Thread-safe LRU cache for PlayableAudioBuffers.

Parity: GraphAudio.Kit/AudioBufferCache.cs — default cap 256 buffers (:13),
``get_or_load`` (:72-85), LRU eviction (:205-216).

The port of graphaudio_tpu/kit/cache.py.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class AudioBufferCacheOptions:
    """Parity: AudioBufferCacheOptions record. 0 = unlimited."""

    max_cached_buffers: int = 256


class AudioBufferCache:
    def __init__(self, options: Optional[AudioBufferCacheOptions] = None):
        self.options = options or AudioBufferCacheOptions()
        self._cache: OrderedDict = OrderedDict()
        self._lock = threading.RLock()

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._cache)

    def try_get(self, key: str):
        """Get without loading; refreshes LRU order (parity: TryGet)."""
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                return self._cache[key]
            return None

    def add(self, key: str, buffer) -> None:
        """Add/replace; evicts the least recently used when full (parity: Add)."""
        with self._lock:
            if key in self._cache:
                del self._cache[key]
            cap = self.options.max_cached_buffers
            if cap > 0 and len(self._cache) >= cap:
                self._cache.popitem(last=False)  # evict LRU
            self._cache[key] = buffer

    def get_or_load(self, key: str, provider):
        """Parity: GetOrLoadAsync (:72-85) — synchronous in this runtime."""
        hit = self.try_get(key)
        if hit is not None:
            return hit
        buffer = provider.get_playable_buffer(key)
        self.add(key, buffer)
        return buffer

    def remove(self, key: str) -> bool:
        with self._lock:
            if key in self._cache:
                del self._cache[key]
                return True
            return False

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._cache

"""Data providers: pluggable audio asset loading.

The port of graphaudio_tpu/kit/providers.py (host code, copied with its
imports swapped).

Parity: GraphAudio.Kit/DataProviders — IDataProvider (stream access) with
helpers producing PlayableAudioBuffers / streaming nodes, and the
path-escape-guarded FileSystemDataProvider.
"""

from __future__ import annotations

import os
from typing import Protocol, runtime_checkable

from graphaudio_tpu_torch.io.decode import AudioDecoder
from graphaudio_tpu_torch.io.stream import AudioDecoderStreamNode


@runtime_checkable
class DataProvider(Protocol):
    """Parity: IDataProvider.GetStreamAsync (:13-22) — returns raw bytes."""

    def get_bytes(self, path: str) -> bytes:  # pragma: no cover - protocol
        ...

    # -- helpers (parity: DataProviderExtensions, :24-46) ----------------------

    def get_playable_buffer(self, path: str):
        return AudioDecoder.load_from_bytes(self.get_bytes(path))

    def get_streaming_node(self, context, path: str,
                           buffer_frames: int = 4096, buffer_count: int = 3):
        return AudioDecoderStreamNode.from_bytes(
            context, self.get_bytes(path), buffer_frames, buffer_count
        )


class FileSystemDataProvider:
    """Local filesystem provider with path-escape guard
    (parity: FileSystemDataProvider.cs:25-41)."""

    def __init__(self, base_path: str):
        if not os.path.isdir(base_path):
            raise FileNotFoundError(f"The base path '{base_path}' does not exist.")
        self._base = os.path.realpath(base_path)

    def get_bytes(self, path: str) -> bytes:
        full = os.path.realpath(os.path.join(self._base, path))
        if not full.startswith(self._base + os.sep) and full != self._base:
            raise PermissionError("Access to the path is denied.")
        if not os.path.isfile(full):
            raise FileNotFoundError(f"The file at path '{path}' was not found.")
        with open(full, "rb") as f:
            return f.read()

    get_playable_buffer = DataProvider.get_playable_buffer
    get_streaming_node = DataProvider.get_streaming_node

"""AudioEngine: the game-facing facade (parity: GraphAudio.Kit/AudioEngine.cs:15).

The port of graphaudio_tpu/kit/engine.py; ``create_streaming_sound`` waits
for the port of ``io`` (ROADMAP.md module item 12) and raises.

Owns the context, the path-addressed bus hierarchy (:81-118), the sound
lifecycle with one-shot reaping (:210-233), the LRU buffer cache (:66-67), and
the listener state forwarded to the spatializer (:257-266).
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

import numpy as np

from graphaudio_tpu_torch.kit.bus import AudioBus
from graphaudio_tpu_torch.kit.cache import AudioBufferCache, AudioBufferCacheOptions
from graphaudio_tpu_torch.kit.sound import BufferedSound, Sound, SoundMixState


class AudioEngine:
    def __init__(self, context, cache_options: Optional[AudioBufferCacheOptions] = None):
        self.context = context
        self.buffer_cache = AudioBufferCache(cache_options)
        self.data_provider = None
        self._buses = {}
        self._master = AudioBus(self, "master", None)
        self._buses["master"] = self._master
        self._sounds: List[Sound] = []
        self._lock = threading.RLock()
        self._listener_position = np.zeros(3, np.float32)
        self._listener_forward = np.array([0, 0, -1], np.float32)
        self._listener_up = np.array([0, 1, 0], np.float32)
        self._deferred: List = []  # (deadline_time, callable)
        self._disposed = False

    # -- listener ---------------------------------------------------------------

    @property
    def master_bus(self) -> AudioBus:
        return self._master

    @property
    def listener_position(self) -> np.ndarray:
        return self._listener_position

    @property
    def listener_forward(self) -> np.ndarray:
        return self._listener_forward

    @property
    def listener_up(self) -> np.ndarray:
        return self._listener_up

    def set_listener(self, position, forward, up) -> None:
        """Parity: AudioEngine.SetListener (:257-266)."""
        self._check()
        self._listener_position = np.asarray(position, np.float32)
        self._listener_forward = np.asarray(forward, np.float32)
        self._listener_up = np.asarray(up, np.float32)
        self.context.set_listener(position, forward, up)

    def set_default_hrir(self, source, **kwargs) -> None:
        """Install a measured HRIR set as the engine context's default for
        all spatialized sounds (see AudioContextBase.set_default_hrir)."""
        self._check()
        self.context.set_default_hrir(source, **kwargs)

    # -- buses (parity: :81-130) -----------------------------------------------------

    def get_bus(self, path: str) -> AudioBus:
        """Get or create a bus by slash-separated path, auto-creating parents."""
        if not path or not path.strip():
            raise ValueError("Bus path cannot be empty.")
        self._check()
        path = path.strip().lower()
        if path in self._buses:
            return self._buses[path]
        if path == "master":
            return self._master

        parts = path.split("/")
        parent = self._master
        current = ""
        for i, part in enumerate(parts):
            part = part.strip()
            if not part:
                raise ValueError(f"Invalid bus path: {path}")
            current = part if i == 0 else f"{current}/{part}"
            bus = self._buses.get(current)
            if bus is None:
                bus = AudioBus(self, current, parent)
                self._buses[current] = bus
            parent = bus
        return parent

    def has_bus(self, path: str) -> bool:
        if not path or not path.strip():
            return False
        return path.strip().lower() in self._buses

    # -- sound creation (parity: :135-205) ---------------------------------------------

    def create_buffered_sound(self, path: str,
                              mix_state: SoundMixState = SoundMixState.DIRECT,
                              bus: Optional[AudioBus] = None) -> BufferedSound:
        self._check()
        if self.data_provider is None:
            raise RuntimeError("data_provider must be set before creating sounds.")
        buffer = self.buffer_cache.get_or_load(path, self.data_provider)
        sound = BufferedSound(self, buffer, mix_state, bus)
        with self._lock:
            self._sounds.append(sound)
        return sound

    def create_streaming_sound(self, path: str,
                               mix_state: SoundMixState = SoundMixState.DIRECT,
                               bus: Optional[AudioBus] = None):
        raise NotImplementedError(
            "streaming sounds need the io package, which is not ported yet "
            "(ROADMAP.md module item 12)"
        )

    def create_sound_from_buffer(self, buffer,
                                 mix_state: SoundMixState = SoundMixState.DIRECT,
                                 bus: Optional[AudioBus] = None) -> BufferedSound:
        """Create a BufferedSound from an in-memory PlayableAudioBuffer."""
        sound = BufferedSound(self, buffer, mix_state, bus)
        with self._lock:
            self._sounds.append(sound)
        return sound

    def play_one_shot(self, path: str,
                      mix_state: SoundMixState = SoundMixState.DIRECT,
                      bus: Optional[AudioBus] = None,
                      setup: Optional[Callable] = None) -> Optional[BufferedSound]:
        """Fire-and-forget playback; the sound is reaped by update()
        (parity: PlayOneShot, :177-205 — errors are logged, not raised)."""
        if self.data_provider is None:
            print("[AudioEngine] Error: data_provider is None")
            return None
        try:
            buffer = self.buffer_cache.get_or_load(path, self.data_provider)
            sound = BufferedSound(self, buffer, mix_state, bus)
            sound.is_one_shot = True
            if setup is not None:
                setup(sound)
            with self._lock:
                self._sounds.append(sound)
            sound.play()
            return sound
        except Exception as ex:  # noqa: BLE001 - parity with reference
            print(f"[AudioEngine] Error in play_one_shot: {ex}")
            return None

    def preload_buffers(self, paths, max_workers: int = 8) -> None:
        """Load a batch of buffers into the cache, decoding in PARALLEL on a
        thread pool (the native codec releases the GIL). Parity:
        PreloadBuffersAsync fans out one task per path and awaits them all
        (AudioEngine.cs:238-252)."""
        self._check()
        if self.data_provider is None:
            raise RuntimeError("data_provider must be set before loading buffers.")
        paths = list(paths)
        if len(paths) <= 1:
            for p in paths:
                self.buffer_cache.get_or_load(p, self.data_provider)
            return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(min(max_workers, len(paths))) as pool:
            # list() propagates the first exception, like Task.WhenAll
            list(pool.map(
                lambda p: self.buffer_cache.get_or_load(p, self.data_provider),
                paths,
            ))

    async def preload_buffers_async(self, paths, max_workers: int = 8) -> None:
        """Awaitable preload (parity: PreloadBuffersAsync, :238-252)."""
        import asyncio

        await asyncio.to_thread(self.preload_buffers, paths, max_workers)

    async def create_buffered_sound_async(
        self, path: str, mix_state: SoundMixState = SoundMixState.DIRECT,
        bus: Optional[AudioBus] = None,
    ) -> "BufferedSound":
        """Awaitable sound creation: the decode runs off-thread (parity:
        CreateBufferedSoundAsync, AudioEngine.cs:135-160)."""
        import asyncio

        return await asyncio.to_thread(
            self.create_buffered_sound, path, mix_state, bus
        )

    # -- per-frame update (parity: :210-233) ---------------------------------------------

    def update(self) -> None:
        """Drive sound updates, deferred fade actions, and one-shot reaping."""
        now = self.context.current_time
        # Partition under the lock: an unlocked rebuild races _defer() from
        # other threads (a fade-end append landing on the old list object is
        # silently lost — the sound then never pauses/stops).
        with self._lock:
            due = [d for d in self._deferred if d[0] <= now]
            self._deferred = [d for d in self._deferred if d[0] > now]
        for _, action in due:
            try:
                action()
            except Exception:
                pass
        with self._lock:
            for sound in list(self._sounds):
                if sound.is_disposed:
                    self._sounds.remove(sound)
                    continue
                sound.update()
                if sound.is_one_shot and not sound.is_playing and not sound.is_looping:
                    sound.dispose()
                    self._sounds.remove(sound)

    def _defer(self, deadline_time: float, action: Callable) -> None:
        with self._lock:
            self._deferred.append((deadline_time, action))

    @property
    def active_sounds(self) -> List[Sound]:
        with self._lock:
            return list(self._sounds)

    # -- lifecycle -----------------------------------------------------------------------

    def dispose(self) -> None:
        if self._disposed:
            return
        with self._lock:
            for sound in self._sounds:
                sound.dispose()
            self._sounds.clear()
        for bus in self._buses.values():
            bus._disconnect()
        self._buses.clear()
        self.context.dispose()
        self._disposed = True

    def _check(self) -> None:
        if self._disposed:
            raise RuntimeError("AudioEngine is disposed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.dispose()
        return False

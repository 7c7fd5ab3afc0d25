"""Realtime playback: native SPSC ring + output device + render thread.

The port of graphaudio_tpu/realtime. Parity: GraphAudio.Realtime —
RingBuffer.cs (lock-free native-memory frame ring with semaphore
backpressure) and RealtimeAudioContext.cs (render thread filling the ring,
device callback draining it in native code).
"""

from graphaudio_tpu_torch.realtime.ring import RingBuffer
from graphaudio_tpu_torch.realtime.context import RealtimeAudioContext, AudioDeviceInfo

__all__ = ["RingBuffer", "RealtimeAudioContext", "AudioDeviceInfo"]

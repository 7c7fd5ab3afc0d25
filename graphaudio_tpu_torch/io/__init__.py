"""Audio IO of the port: decoding (native codec) and streaming source nodes.

The port of graphaudio_tpu/io: the same thirteen names. The decoders and
encoders are host code over the port's own copy of the native codec
(native/gacodec.cpp, built with g++ into _build/); the stream node reads its
per-call feed with K15 (ops/stream.py) on the card.

Parity: GraphAudio.IO — libsndfile-backed AudioDecoder (ours decodes
WAV/RF64/Wave64/AIFF/AU/CAF/FLAC/IMA+MS-ADPCM natively, plus MP3,
Ogg/Vorbis, and Ogg Opus through the system's libmpg123 / libvorbisfile /
libogg+libopus, dlopen'd at runtime; see codec_capabilities())
(LibsndfileDecoder.cs) and the double-buffered decoder-thread streaming node
(AudioDecoderStreamNode.cs). The native backend here is our own C++ codec
(native/gacodec.cpp) with a pure-Python WAV fallback; encoders cover
WAV/FLAC/MP3/Ogg/Opus.
"""

from graphaudio_tpu_torch.io.decode import (
    AudioDecoder,
    codec_capabilities,
    write_aiff,
    write_alac,
    write_au,
    write_caf,
    write_flac,
    write_mp3,
    write_ogg,
    write_opus,
    write_wav,
)
from graphaudio_tpu_torch.io.stream import AudioDecoderStreamNode, StreamState

__all__ = [
    "AudioDecoder",
    "codec_capabilities",
    "write_aiff",
    "write_alac",
    "write_au",
    "write_caf",
    "write_flac",
    "write_mp3",
    "write_ogg",
    "write_opus",
    "write_wav",
    "AudioDecoderStreamNode",
    "StreamState",
]

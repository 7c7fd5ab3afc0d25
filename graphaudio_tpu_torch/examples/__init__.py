"""The port's twins of the JAX package's examples (``examples/*.py``).

Each module has the JAX script's name and its ``main`` arguments, plus a
keyword ``device``: ``"cuda"`` (the default, which raises where CUDA is
absent, as ``OfflineAudioContext`` does) or ``"cpu"`` (the kernels' plain
PyTorch versions). Each draws its data from the same seeded numpy
generators as its JAX twin, so both packages render the same scene, and
writes its output where the JAX script does. Run one as

    python -m graphaudio_tpu_torch.examples.<name> [out]

* ``offline_mixdown``: sawtooth chords through an exponentially opening
  lowpass, noise hits through stereo panners and a 1 s stereo convolution
  reverb, 5 s to a WAV;
* ``timed_automation``: ``post_at`` edits inside one render call (a
  param, then a new oscillator and gain, then a stop);
* ``game_audio``: the Kit engine, a looping binaural sound on a moving
  anchor, one-shots on an ``sfx`` bus with a reverb send, 60 ticks of
  50 ms;
* ``measured_hrtf_flac``: a 96-tap HRIR set from arrays on one spatial
  panner, 32 calls with position edits, 24-bit FLAC and its round trip;
* ``pcm_delivery_opus``: a context-wide HRIR set, 8 spatial panners,
  ``render_pcm16``, and Ogg Opus where the machine's codecs allow it;
* ``multichip_scene``: a voice scene sharded over ``n_devices`` ranks
  joined by gloo (on the one card, or on the CPU).

The modules import ``torch``, numpy and this package only.
"""

NAMES = (
    "game_audio",
    "measured_hrtf_flac",
    "multichip_scene",
    "offline_mixdown",
    "pcm_delivery_opus",
    "timed_automation",
)

"""rtlsdr_wsprd_tpu — a JAX WSPR decode framework.

A from-scratch rebuild of the capabilities of Guenael/rtlsdr-wsprd as
batched, sharded accelerator computation in JAX/XLA:

* ``utils``    — bit-exact host protocol codecs (callsign hash, message
                 pack/unpack, convolutional code, interleaver).
* ``ops``      — the device compute path: STFT spectrogram, candidate
                 search, batched sync/demodulation correlators, batched
                 Fano FEC decode, coherent signal subtraction.
* ``frontend`` — the polyphase front end (2.4 Msps -> 375 sps).
* ``models``   — the flagship ``WsprDecoder`` pipeline: one jitted
                 program decoding all candidates x lags x drifts x
                 jitters of a 2-minute window at once.
* ``parallel`` — device-mesh sharding: channels/windows over devices
                 and hosts, halo exchange for streaming filter state.
* ``runtime``  — host orchestration: 2-minute scheduler, IQ sources,
                 daemon shell.
"""

__version__ = "0.1.0"

from .config import DecoderOptions, ReceiverOptions  # noqa: F401

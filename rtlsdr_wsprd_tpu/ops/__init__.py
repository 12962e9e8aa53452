"""Device compute path: batched JAX ops for the WSPR decode chain."""

from .stft import power_spectrogram, BLOCKS  # noqa: F401
from .candidates import find_candidates  # noqa: F401
from .coarse import coarse_search  # noqa: F401
from .sync import fine_sync, soft_symbols_jittered  # noqa: F401
from .fano import batched_fano, build_mettab  # noqa: F401
from .subtract import subtract_signal, subtract_signal2  # noqa: F401

"""Host-side IO (L0): audio decode/probe, config, native loader bindings.

Copies of the JAX package's backend-free ``io`` modules (importing that
package would load jax). ``io/config.py`` imports ``yaml`` only inside
its loaders.
"""

from audioanalysisdetector_tpu_torch.io.audio import (
    AudioInfo,
    audio_info,
    load_audio,
    load_chunk_batch,
    resample_poly_host,
    write_wav,
)
from audioanalysisdetector_tpu_torch.io.flac import (
    FlacError,
    FlacStreamInfo,
    decode_flac,
    flac_stream_info,
    read_flac,
    write_flac,
)
from audioanalysisdetector_tpu_torch.io.config import (
    DEFAULT_COLUMNS,
    DEFAULT_CONFIG_TEMPLATE,
    ConfigNode,
    load_config,
    loads_config,
)
from audioanalysisdetector_tpu_torch.io.native_loader import (
    audio_info_native,
    load_chunk_batch_native,
    native_available,
)

__all__ = [
    "AudioInfo",
    "ConfigNode",
    "DEFAULT_COLUMNS",
    "DEFAULT_CONFIG_TEMPLATE",
    "FlacError",
    "FlacStreamInfo",
    "audio_info",
    "audio_info_native",
    "decode_flac",
    "flac_stream_info",
    "load_audio",
    "load_chunk_batch",
    "load_chunk_batch_native",
    "load_config",
    "loads_config",
    "native_available",
    "read_flac",
    "resample_poly_host",
    "write_flac",
    "write_wav",
]

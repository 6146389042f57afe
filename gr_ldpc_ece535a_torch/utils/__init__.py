"""Utilities: config system, profiling/metrics, BMP helpers.

The counterpart of ``gr_ldpc_ece535a_tpu/utils/``. The reference has exactly
one runtime parameter (the decoder method enum) and hardcodes everything
else — iterations=5, sync threshold M/8, max 10 bad frames
(lib/ldpc_decoder_cb_impl.cc:39-40,141-142,171). This package promotes
those constants to a config layer and adds timing counters. JAX's
``enable_persistent_compile_cache`` has no counterpart: the port's compiled
kernels are cached in the package's ``_build/`` directory.
"""

from .bmp import make_bmp, parse_bmp_header
from .config import ChannelConfig, PipelineConfig, ReceiverConfig, SimConfig
from .profiling import Timer, ThroughputMeter, device_sync, trace

__all__ = [
    "ChannelConfig",
    "PipelineConfig",
    "ReceiverConfig",
    "SimConfig",
    "ThroughputMeter",
    "Timer",
    "device_sync",
    "make_bmp",
    "parse_bmp_header",
    "trace",
]

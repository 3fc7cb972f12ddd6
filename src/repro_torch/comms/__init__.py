"""What a sync event moves (counterpart of ``repro.comms``): ``FlatBucket``
buffers, the identity and int8 wire codecs, and ``WireStats`` byte
accounting.  Enable with ``EngineConfig(comms="int8")``."""
from repro_torch.comms.codecs import (COMPRESSORS, Compressor,
                                      IdentityCompressor, Int8Compressor,
                                      make_compressor)
from repro_torch.comms.flat import FlatBucket
from repro_torch.comms.reduce import SimWireOps
from repro_torch.comms.sync import Comms, make_comms
from repro_torch.comms.wire import WireArray, WireStats

__all__ = [
    "Comms", "make_comms", "FlatBucket", "SimWireOps",
    "Compressor", "IdentityCompressor", "Int8Compressor", "COMPRESSORS",
    "make_compressor", "WireArray", "WireStats",
]

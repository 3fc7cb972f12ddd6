"""What a sync event moves (counterpart of ``repro.comms``): ``FlatBucket``
buffers, the identity, int8, sign and top-k wire codecs, the WireOps each
executor reduces through, and ``WireStats`` byte accounting.  Enable with
``EngineConfig(comms="int8")``."""
from repro_torch.comms.codecs import (COMPRESSORS, Compressor,
                                      IdentityCompressor, Int8Compressor,
                                      SignCompressor, TopKCompressor,
                                      make_compressor)
from repro_torch.comms.flat import FlatBucket
from repro_torch.comms.reduce import ExactWireOps, MeshWireOps, SimWireOps
from repro_torch.comms.sync import Comms, make_comms
from repro_torch.comms.wire import WireArray, WireStats

__all__ = [
    "Comms", "make_comms", "FlatBucket", "SimWireOps", "MeshWireOps",
    "ExactWireOps", "Compressor", "IdentityCompressor", "Int8Compressor",
    "SignCompressor", "TopKCompressor", "COMPRESSORS",
    "make_compressor", "WireArray", "WireStats",
]

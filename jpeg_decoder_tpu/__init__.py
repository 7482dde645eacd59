"""jpeg_decoder_tpu — an accelerator JPEG decode engine in JAX/XLA.

Brand-new framework with the capabilities of the reference C++ decoder
(aswanthabam/JPEG_Decoder), re-architected for accelerators: host-side
marker/header parsing and byte-unstuffing, table-driven Huffman entropy
decode (host C++ or on-device lanes, parallel over restart intervals or
host-found MCU starts), and fused
dequantize + IDCT + chroma-upsample + YCbCr->RGB device kernels, sharded over
{images x segments} meshes via shard_map.
"""

from .models.decoder import DecodeResult, decode, decode_to_file  # noqa: F401
from .io.parser import parse, parse_file  # noqa: F401
from .types import FrameHeader, JPEGError  # noqa: F401

__version__ = "0.1.0"

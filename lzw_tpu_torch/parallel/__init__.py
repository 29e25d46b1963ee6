"""The LZWT block container over torch devices and processes."""

from lzw_tpu_torch.parallel import framing
from lzw_tpu_torch.parallel.block import (
    BlockParallelCodec, default_devices, local_devices,
)
from lzw_tpu_torch.parallel.framing import FrameHeader, pack_frame, parse_frame
from lzw_tpu_torch.parallel.multihost import MultiHostBlockCodec

__all__ = ["BlockParallelCodec", "FrameHeader", "MultiHostBlockCodec",
           "default_devices", "framing", "local_devices", "pack_frame",
           "parse_frame"]

"""The LZWT block container on one torch device."""

from lzw_tpu_torch.parallel import framing
from lzw_tpu_torch.parallel.block import BlockParallelCodec

__all__ = ["BlockParallelCodec", "framing"]

"""lzw_tpu_torch: the PyTorch + CUDA port of lzw_tpu for NVIDIA Hopper.

Block-parallel LZW, byte-exact with salzweg's three wire flavors, over the
LZWT block container on one or more GPUs (:class:`BlockParallelCodec`) and
across processes (:class:`~lzw_tpu_torch.parallel.MultiHostBlockCodec`),
and salzweg's single-stream facades (:class:`GifCodec`, :class:`TiffCodec`,
:class:`FixedCodec`, :class:`VariableCodec`).  The JAX package ``lzw_tpu`` is the reference; this
package imports torch and numpy and never jax or ``lzw_tpu``, and reads no
file of it: the native C++ runtime's source is a copy of the JAX package's.
"""

from lzw_tpu_torch.api import (
    FixedCodec,
    GifCodec,
    LzwCodec,
    TiffCodec,
    VariableCodec,
)
from lzw_tpu_torch.parallel import BlockParallelCodec
from lzw_tpu_torch.spec import (
    CodeSizeError,
    CodeSizeStrategy,
    DecodingError,
    EncodingError,
    Endianness,
    LzwError,
    LzwSpec,
    MissingClearCodeError,
    TruncatedStreamError,
    UnexpectedCodeError,
    VerificationError,
    from_reference_spec,
)

__all__ = [
    "BlockParallelCodec",
    "CodeSizeError",
    "CodeSizeStrategy",
    "DecodingError",
    "EncodingError",
    "Endianness",
    "FixedCodec",
    "GifCodec",
    "LzwCodec",
    "LzwError",
    "LzwSpec",
    "MissingClearCodeError",
    "TiffCodec",
    "TruncatedStreamError",
    "UnexpectedCodeError",
    "VariableCodec",
    "VerificationError",
    "from_reference_spec",
]

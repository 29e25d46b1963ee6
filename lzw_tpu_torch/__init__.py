"""lzw_tpu_torch: the PyTorch + CUDA port of lzw_tpu for NVIDIA Hopper.

Block-parallel LZW, byte-exact with salzweg's three wire flavors, over the
LZWT block container.  The JAX package ``lzw_tpu`` is the reference; this
package imports torch and numpy and never jax or ``lzw_tpu``.  The only
code the two share is the native C++ runtime's source, compiled by path.
"""

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
    "LzwError",
    "LzwSpec",
    "MissingClearCodeError",
    "TruncatedStreamError",
    "UnexpectedCodeError",
    "VerificationError",
    "from_reference_spec",
]

"""Wire-format description and error contract of the PyTorch port.

A line-for-line port of ``lzw_tpu/spec.py``: the same ``LzwSpec`` fields and
constructors, the same error classes with the same messages, so callers can
catch the same cases in either package.  The port cannot import the JAX
package (its ``__init__`` imports jax), so the module is copied rather than
shared; :func:`from_reference_spec` converts a JAX ``LzwSpec`` by its fields.
"""

from __future__ import annotations

import dataclasses
import enum

__all__ = [
    "Endianness",
    "CodeSizeStrategy",
    "LzwSpec",
    "LzwError",
    "EncodingError",
    "DecodingError",
    "CodeSizeError",
    "UnexpectedCodeError",
    "MissingClearCodeError",
    "TruncatedStreamError",
    "BlockOverflowError",
    "VerificationError",
    "MAX_WIDTH",
    "MAX_TABLE_SIZE",
    "MAX_WORD_LEN",
    "from_reference_spec",
]

MAX_WIDTH = 12
MAX_TABLE_SIZE = 4096
# Longest decodable word: 4096 - 2^2 - 2 + 1.
MAX_WORD_LEN = 4091


class Endianness(enum.Enum):
    """Bit-packing order of codes in the compressed byte stream."""

    BIG = "big"
    LITTLE = "little"


class CodeSizeStrategy(enum.Enum):
    """When the variable-width read/write size bumps.

    DEFAULT bumps when the dictionary reaches ``2**width``; TIFF bumps one code
    earlier ("early change", ``2**width - 1``).
    """

    DEFAULT = 0
    TIFF = 1

    @property
    def increment(self) -> int:
        return self.value


class LzwError(Exception):
    """Base class for all LZW codec errors."""


class EncodingError(LzwError):
    """Base class for errors raised while encoding."""


class DecodingError(LzwError):
    """Base class for errors raised while decoding."""


class CodeSizeError(EncodingError, DecodingError):
    """Code size out of bounds; it must be between 2 and 8 included."""

    def __init__(self, code_size: int):
        self.code_size = code_size
        super().__init__(f"Code size must be between 2 and 8, was {code_size}.")


class UnexpectedCodeError(EncodingError, DecodingError):
    """An out-of-range symbol was encountered.

    While encoding: an input byte >= 2**code_size.  While decoding: a code
    beyond the next free dictionary index or a corrupt copy chain.
    """

    def __init__(self, code: int, code_size: int | None = None):
        self.code = code
        self.code_size = code_size
        if code_size is not None:
            msg = (
                f"Unexpected code {code}. For code size {code_size}, "
                f"data should be < {1 << code_size}."
            )
        else:
            msg = f"Unexpected code while decompressing: {code}"
        super().__init__(msg)


class MissingClearCodeError(DecodingError):
    """The dictionary would grow past 4096 entries without a CLEAR code."""

    def __init__(self):
        super().__init__(
            "Dictionary growing past 4096, expected CLEAR_CODE missing"
        )


class TruncatedStreamError(DecodingError):
    """The compressed stream ended before an expected code could be read."""

    def __init__(self):
        super().__init__("Compressed stream ended unexpectedly")


class BlockOverflowError(DecodingError):
    """A container block decodes past its ``block_size``, and the decoder
    that found it cannot name the code that passes the bound (the native
    runtime's ``decode_blocks``, whose library reports only a full
    buffer).  The block container names it: see
    :class:`lzw_tpu_torch.BlockParallelCodec`."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        super().__init__(f"A block decodes past its {block_size} bytes")


class VerificationError(EncodingError):
    """An encoded payload failed the container's round-trip self-check."""

    def __init__(self, block_index: int, detail: str = ""):
        self.block_index = block_index
        msg = f"Encoded payload failed round-trip verification at block " \
              f"{block_index}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


@dataclasses.dataclass(frozen=True)
class LzwSpec:
    """Immutable description of one LZW wire format.

    Use the class methods :meth:`gif`, :meth:`tiff`, :meth:`fixed` or
    :meth:`variable` instead of the raw constructor.
    """

    code_size: int
    endianness: Endianness
    strategy: CodeSizeStrategy
    variable: bool  # variable-width with CLEAR/EOI vs fixed 12-bit, no controls

    @classmethod
    def gif(cls, code_size: int) -> "LzwSpec":
        """GIF-style: caller code size 2..=8, LSB-first, default strategy."""
        return cls(code_size, Endianness.LITTLE, CodeSizeStrategy.DEFAULT, True)

    @classmethod
    def tiff(cls) -> "LzwSpec":
        """TIFF-style: code size 8, MSB-first, early-change strategy."""
        return cls(8, Endianness.BIG, CodeSizeStrategy.TIFF, True)

    @classmethod
    def fixed(cls, endianness: Endianness) -> "LzwSpec":
        """Original fixed 12-bit LZW: byte alphabet, no CLEAR/EOI codes."""
        return cls(8, endianness, CodeSizeStrategy.DEFAULT, False)

    @classmethod
    def variable(
        cls,
        code_size: int,
        endianness: Endianness,
        strategy: CodeSizeStrategy = CodeSizeStrategy.DEFAULT,
    ) -> "LzwSpec":
        """Generic variable-width flavor with explicit parameters."""
        return cls(code_size, endianness, strategy, True)

    def validate(self) -> None:
        """Raise :class:`CodeSizeError` unless 2 <= code_size <= 8.

        Only the variable flavors validate; the fixed flavor hard-wires code
        size 8.
        """
        if self.variable and not 2 <= self.code_size <= 8:
            raise CodeSizeError(self.code_size)

    @property
    def alphabet_size(self) -> int:
        return 1 << self.code_size

    @property
    def clear_code(self) -> int:
        """Only meaningful for variable flavors."""
        return 1 << self.code_size

    @property
    def end_code(self) -> int:
        """END-OF-INFORMATION; only meaningful for variable flavors."""
        return (1 << self.code_size) + 1

    @property
    def first_free_code(self) -> int:
        """Index of the first dictionary entry added at runtime."""
        return self.alphabet_size + 2 if self.variable else self.alphabet_size

    @property
    def initial_width(self) -> int:
        """Read/write width right after (re)initialisation."""
        return self.code_size + 1 if self.variable else MAX_WIDTH

    @property
    def max_code_value(self) -> int:
        """Largest input byte value the encoder accepts beyond the first byte."""
        return self.alphabet_size - 1

    def width_bump_threshold(self, width: int) -> int:
        """Dictionary size at which the width bumps past ``width``."""
        return (1 << width) - self.strategy.increment

    def wire_key(self) -> tuple:
        """Canonical key of the *wire format* this spec describes.

        The fixed flavor hard-wires code size 8 and never consults the
        width-bump strategy, so those fields are excluded for it.
        """
        if self.variable:
            return (True, self.code_size, self.endianness, self.strategy)
        return (False, self.endianness)

    def wire_equivalent(self, other: "LzwSpec") -> bool:
        """True when ``other`` reads/writes the same byte streams as self."""
        return self.wire_key() == other.wire_key()


def from_reference_spec(obj) -> LzwSpec:
    """The port's spec for any object with ``LzwSpec``'s four fields.

    Duck-typed so it converts a ``lzw_tpu.spec.LzwSpec`` without importing
    the JAX package: enum members are matched by value.
    """
    return LzwSpec(
        int(obj.code_size),
        Endianness(obj.endianness.value),
        CodeSizeStrategy(obj.strategy.value),
        bool(obj.variable),
    )

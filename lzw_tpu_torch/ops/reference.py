"""Scalar reference oracle for all three LZW flavors.

The port's own copy of ``lzw_tpu/ops/reference.py`` (the port imports
nothing of the JAX package): a plain-Python, bit-exact implementation of
the salzweg wire formats, pinned against the reference's golden vectors
(``test-assets/lorem_ipsum_encoded.bin`` and the doctest byte strings in
``lzw/src/encoder.rs`` / ``decoder.rs``).  It backs the ``"oracle"``
backend of :mod:`lzw_tpu_torch.api`.

It deliberately trades speed for clarity: the encoder dictionary is a Python
``dict`` keyed by ``(prefix_code, byte)`` (the reference uses an arena trie,
`encoder.rs:67-149`, purely as a CPU micro-optimisation — the *language* of the
dictionary is the (prefix, byte) -> code map), and the decoder keeps the
prefix/suffix/length tables from `decoder.rs:197-199` as Python lists.

Semantic corners intentionally preserved:

* The first input byte is never range-checked (`encoder.rs:311` happens before
  the loop's check at `:315-317`).
* Variable encode emits CLEAR first, and CLEAR+EOI for an empty stream
  (`encoder.rs:297,300-309`).
* At width 12 with a full table the encoder emits CLEAR at 12 bits and resets
  (`encoder.rs:330-333`); the entry that triggered the reset is discarded.
* The decoder's tables are *not* cleared on reset (`decoder.rs:222-227` only
  resets indices), so a corrupt first-code-after-reset reads stale bytes; we
  reproduce that byte-for-byte.
* Fixed decode terminates on bit exhaustion (no EOI), discarding a trailing
  partial code (`io.rs:58-78`, `decoder.rs:585`).
"""

from __future__ import annotations

from lzw_tpu_torch.spec import (
    Endianness,
    LzwSpec,
    MAX_TABLE_SIZE,
    MAX_WIDTH,
    MissingClearCodeError,
    TruncatedStreamError,
    UnexpectedCodeError,
)

__all__ = [
    "encode_bytes",
    "decode_bytes",
    "encode_codes",
    "pack_codes",
    "unpack_codes_fixed",
    "eoi_width_quirk",
]


# --------------------------------------------------------------------------- #
# Bit packing                                                                 #
# --------------------------------------------------------------------------- #


def pack_codes(
    codes_and_widths: list[tuple[int, int]], endianness: Endianness
) -> bytes:
    """Pack (code, width) pairs into bytes; LSB-first or MSB-first.

    Matches the accumulator semantics of `io.rs:229-265` (little endian) and
    `io.rs:291-322` (big endian), including the final partial-byte ``fill()``.
    """
    out = bytearray()
    acc = 0  # pending bits
    nbits = 0
    if endianness is Endianness.LITTLE:
        for code, width in codes_and_widths:
            acc |= (code & ((1 << width) - 1)) << nbits
            nbits += width
            while nbits >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nbits -= 8
        if nbits:
            out.append(acc & 0xFF)
    else:
        for code, width in codes_and_widths:
            acc = (acc << width) | (code & ((1 << width) - 1))
            nbits += width
            while nbits >= 8:
                out.append((acc >> (nbits - 8)) & 0xFF)
                nbits -= 8
        if nbits:
            out.append((acc << (8 - nbits)) & 0xFF)
    return bytes(out)


def unpack_codes_fixed(data: bytes, width: int, endianness: Endianness) -> list[int]:
    """Unpack as many ``width``-bit codes as fully fit in ``data``.

    Trailing bits that cannot form a whole code are discarded, matching the
    EOF-tolerant bulk read of `io.rs:58-78`.
    """
    n_codes = (8 * len(data)) // width
    out = []
    if endianness is Endianness.LITTLE:
        for i in range(n_codes):
            bit = i * width
            byte, sh = bit >> 3, bit & 7
            window = int.from_bytes(data[byte : byte + 3].ljust(3, b"\0"), "little")
            out.append((window >> sh) & ((1 << width) - 1))
    else:
        for i in range(n_codes):
            bit = i * width
            byte, sh = bit >> 3, bit & 7
            window = int.from_bytes(data[byte : byte + 3].ljust(3, b"\0"), "big")
            out.append((window >> (24 - sh - width)) & ((1 << width) - 1))
    return out


class _BitCursor:
    """Sequential variable-width code reader over a byte string."""

    def __init__(self, data: bytes, endianness: Endianness):
        self.data = data
        self.total_bits = 8 * len(data)
        self.pos = 0
        self.little = endianness is Endianness.LITTLE

    def read(self, width: int) -> int:
        """Read one code; raises TruncatedStreamError past the end."""
        if self.pos + width > self.total_bits:
            raise TruncatedStreamError()
        byte, sh = self.pos >> 3, self.pos & 7
        chunk = self.data[byte : byte + 3]
        if self.little:
            window = int.from_bytes(chunk.ljust(3, b"\0"), "little")
            value = (window >> sh) & ((1 << width) - 1)
        else:
            window = int.from_bytes(chunk.ljust(3, b"\0"), "big")
            value = (window >> (24 - sh - width)) & ((1 << width) - 1)
        self.pos += width
        return value


# --------------------------------------------------------------------------- #
# Encode                                                                      #
# --------------------------------------------------------------------------- #


def encode_codes(data: bytes, spec: LzwSpec) -> list[tuple[int, int]]:
    """Greedy LZW parse -> list of (code, write_width) pairs.

    Control codes (CLEAR / END-OF-INFORMATION) are included in the list for
    variable flavors, so ``pack_codes(encode_codes(...))`` is the full wire
    stream.  Semantics mirror `encoder.rs:273-346` (variable) and
    `encoder.rs:618-658` (fixed).
    """
    spec.validate()
    out: list[tuple[int, int]] = []

    if spec.variable:
        width = spec.initial_width
        threshold = spec.width_bump_threshold(width)
        out.append((spec.clear_code, width))
        if not data:
            out.append((spec.end_code, width))
            return out

        table: dict[tuple[int, int], int] = {}
        next_index = spec.first_free_code
        prefix = data[0]
        max_code = spec.max_code_value
        for k in data[1:]:
            if k > max_code:
                raise UnexpectedCodeError(k, spec.code_size)
            child = table.get((prefix, k))
            if child is not None:
                prefix = child
                continue
            new_index = next_index
            table[(prefix, k)] = new_index
            next_index += 1
            out.append((prefix, width))
            prefix = k
            if new_index == threshold:
                if width < MAX_WIDTH:
                    width += 1
                else:
                    out.append((spec.clear_code, MAX_WIDTH))
                    width = spec.initial_width
                    table.clear()
                    next_index = spec.first_free_code
                threshold = spec.width_bump_threshold(width)
        out.append((prefix, width))
        out.append((spec.end_code, width))
    else:
        if not data:
            return out
        table = {}
        next_index = spec.first_free_code
        prefix = data[0]
        for k in data[1:]:
            child = table.get((prefix, k))
            if child is not None:
                prefix = child
                continue
            if next_index < MAX_TABLE_SIZE:
                table[(prefix, k)] = next_index
                next_index += 1
            out.append((prefix, MAX_WIDTH))
            prefix = k
        out.append((prefix, MAX_WIDTH))
    return out


def encode_bytes(data: bytes, spec: LzwSpec) -> bytes:
    """Full encode: greedy parse + bit packing."""
    return pack_codes(encode_codes(data, spec), spec.endianness)


def eoi_width_quirk(codes_and_widths: list[tuple[int, int]], spec: LzwSpec) -> bool:
    """True if a salzweg decoder would misread this (self-produced) stream.

    Reference quirk, reproduced bit-for-bit by this framework: the decoder
    bumps its read width after the insert that accompanies *every* code past
    the first (`decoder.rs:272-280`), but the encoder's final prefix code is
    not a dictionary miss, so the encoder never bumps before writing EOI
    (`encoder.rs:339-340`).  If the decoder-side insert for the final data
    code lands exactly on a width-bump threshold, the decoder expects EOI one
    bit wider than it was written.  Little-endian streams often survive by
    reading a zero padding bit; big-endian streams misparse, and streams with
    no slack bits hit end-of-stream.

    This simulates the decoder's width schedule over the emitted code list and
    reports any divergence from the widths actually written.
    """
    if not spec.variable:
        return False
    read_size = spec.initial_width
    threshold = spec.width_bump_threshold(read_size)
    next_index = spec.first_free_code
    previous: int | None = None
    for code, width in codes_and_widths:
        if width != read_size:
            return True
        if code == spec.clear_code:
            read_size = spec.initial_width
            threshold = spec.width_bump_threshold(read_size)
            next_index = spec.first_free_code
            previous = None
            continue
        if code == spec.end_code:
            return False
        if previous is None:
            previous = code
            continue
        if next_index < MAX_TABLE_SIZE:
            next_index += 1
            if next_index == threshold and read_size < MAX_WIDTH:
                read_size += 1
                threshold = spec.width_bump_threshold(read_size)
        previous = code
    return False


# --------------------------------------------------------------------------- #
# Decode                                                                      #
# --------------------------------------------------------------------------- #


def decode_bytes(data: bytes, spec: LzwSpec) -> bytes:
    """Decode one compressed stream back to bytes.

    Mirrors `decoder.rs:174-290` (variable) and `decoder.rs:553-642` (fixed),
    including the stale-table behaviour on dictionary reset.
    """
    spec.validate()
    prefix = [0] * MAX_TABLE_SIZE
    suffix = [0] * MAX_TABLE_SIZE
    length = [0] * MAX_TABLE_SIZE
    for c in range(spec.alphabet_size):
        suffix[c] = c
        length[c] = 1

    out = bytearray()
    previous: int | None = None
    next_index = spec.first_free_code
    alphabet = spec.alphabet_size

    if spec.variable:
        cursor = _BitCursor(data, spec.endianness)
        read_size = spec.initial_width
        threshold = spec.width_bump_threshold(read_size)
        clear, end = spec.clear_code, spec.end_code
        while True:
            code = cursor.read(read_size)
            if code == clear:
                read_size = spec.initial_width
                threshold = spec.width_bump_threshold(read_size)
                next_index = spec.first_free_code
                previous = None
                continue
            if code == end:
                break
            previous, word = _decode_step(
                code, previous, prefix, suffix, length, next_index, alphabet, clear
            )
            if word is None:  # first code after reset: single literal
                out.append(suffix[code])
                continue
            out.extend(word)
            if next_index >= MAX_TABLE_SIZE:
                raise MissingClearCodeError()
            prefix[next_index] = previous
            suffix[next_index] = word[0]
            length[next_index] = length[previous] + 1
            next_index += 1
            if next_index == threshold and read_size < MAX_WIDTH:
                read_size += 1
                threshold = spec.width_bump_threshold(read_size)
            previous = code
    else:
        for code in unpack_codes_fixed(data, MAX_WIDTH, spec.endianness):
            previous, word = _decode_step(
                code, previous, prefix, suffix, length, next_index, alphabet, alphabet
            )
            if word is None:
                out.append(suffix[code])
                continue
            out.extend(word)
            if next_index < MAX_TABLE_SIZE:
                prefix[next_index] = previous
                suffix[next_index] = word[0]
                length[next_index] = length[previous] + 1
                next_index += 1
            previous = code
    return bytes(out)


def _decode_step(
    code: int,
    previous: int | None,
    prefix: list[int],
    suffix: list[int],
    length: list[int],
    next_index: int,
    alphabet: int,
    root_bound: int,
) -> tuple[int | None, bytearray | None]:
    """One table-driven decode step; returns (previous_code, word or None).

    ``None`` word flags the first-code-after-reset literal path
    (`decoder.rs:230-236`); the caller emits ``suffix[code]`` itself so the
    stale-table semantics stay in one place.
    """
    if previous is None:
        return code, None
    if code > next_index:
        raise UnexpectedCodeError(code)
    if code == next_index:
        # KwKwK: previous word plus its own first character (`decoder.rs:244-250`).
        word = _materialize(previous, prefix, suffix, length, root_bound)
        word.append(word[0])
    else:
        word = _materialize(code, prefix, suffix, length, root_bound)
    return previous, word


def _materialize(
    code: int,
    prefix: list[int],
    suffix: list[int],
    length: list[int],
    root_bound: int,
) -> bytearray:
    """Walk the suffix chain backwards to rebuild a word (`decoder.rs:251-267`)."""
    n = length[code]
    word = bytearray(n)
    pos = n
    while code >= root_bound:
        pos -= 1
        if pos <= 0:
            raise UnexpectedCodeError(code)
        word[pos] = suffix[code]
        code = prefix[code]
    word[0] = code
    return word

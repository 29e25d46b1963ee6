"""Plain NumPy LZW in salzweg's wire formats, vectorised across blocks.

The benchmark's reference: written from the formats (``SURVEY.md`` §3;
salzweg's ``encoder.rs`` and ``decoder.rs``), importing nothing of the
program.  Many independent streams (the container's blocks) advance in
lockstep, one input byte (encode) or one code (decode) a step, so a step
is a few NumPy operations over every stream at once.  A single stream
(the facade's) is parsed by a dictionary instead (:func:`parse_stream`),
which the tests hold equal to the lockstep parse of one row.

Formats:

* Variable (GIF- and TIFF-style): CLEAR first, codes growing from
  ``code_size + 1`` to 12 bits, a width bump when the next dictionary
  index reaches ``2**width`` (TIFF's early change: one sooner), a CLEAR
  and a reset when the table is full at 12 bits, the last prefix, then
  EOI.  Packed LSB-first (little endian) or MSB-first (big endian).
* Fixed 12-bit: no control codes, the dictionary frozen at 4096 entries,
  the stream ending with its bytes.

Each code is masked to its width when packed, so a first byte past the
alphabet lands in its slot as the container writes it.  ``fix_eoi``
widens the EOI to the width the decoder expects after the last code, the
container's fix of salzweg's EOI quirk; without it the bytes are
salzweg's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAX_WIDTH = 12
TABLE = 1 << MAX_WIDTH
# Host bytes a parse's dictionary may take (int32 entries, keyed by
# stream, prefix code and byte); streams beyond it parse in further chunks
# that reuse it.
TABLE_BUDGET = 1 << 30
# Streams packed or decoded together: their symbol and node arrays take a
# few hundred MiB at most.
LANES = 512


@dataclasses.dataclass(frozen=True)
class Wire:
    """One wire format: the variable flavor with its code size, byte order
    and early change, or the fixed 12-bit flavor with its byte order."""

    variable: bool
    code_size: int = 8
    little: bool = True
    early_change: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "Wire":
        flavor = d["flavor"]
        if flavor not in ("variable", "fixed"):
            raise ValueError(f"flavor {flavor!r} is not 'variable' or 'fixed'")
        endian = d.get("endianness", "little")
        if endian not in ("little", "big"):
            raise ValueError(f"endianness {endian!r}")
        strategy = d.get("strategy", "default")
        if strategy not in ("default", "tiff"):
            raise ValueError(f"strategy {strategy!r}")
        variable = flavor == "variable"
        code_size = int(d.get("code_size", 8))
        if variable and not 2 <= code_size <= 8:
            raise ValueError(f"code size {code_size} is not in 2..8")
        return cls(variable, code_size if variable else 8, endian == "little",
                   strategy == "tiff")

    @property
    def alphabet(self) -> int:
        return 1 << self.code_size

    @property
    def clear(self) -> int:
        return self.alphabet

    @property
    def eoi(self) -> int:
        return self.alphabet + 1

    @property
    def first_free(self) -> int:
        return self.alphabet + 2 if self.variable else self.alphabet

    @property
    def initial_width(self) -> int:
        return self.code_size + 1 if self.variable else MAX_WIDTH

    def threshold(self, width: int) -> int:
        """The dictionary index at which the width grows past ``width``."""
        return (1 << width) - (1 if self.early_change else 0)


def epoch_widths(wire: Wire) -> np.ndarray:
    """The write width of each data code of one dictionary epoch of a
    variable stream; a CLEAR follows the epoch's last code.  Every epoch
    starts at the same width and index, so the pattern repeats."""
    widths = []
    width = wire.initial_width
    nxt = wire.first_free
    while True:
        widths.append(width)
        new = nxt
        nxt += 1
        if new == wire.threshold(width):
            if width == MAX_WIDTH:
                return np.asarray(widths, np.int64)
            width += 1


# --------------------------------------------------------------------------- #
# Encode                                                                      #
# --------------------------------------------------------------------------- #


def parse(rows: np.ndarray, wire: Wire, *, flush: bool = True):
    """The data codes of each row of ``rows`` (u8[n, L], every row one
    whole stream of L bytes): (codes u16[n, L], counts i64[n]).

    ``flush=False`` leaves out each stream's last code, the prefix left
    when the input ends: the benchmark's control, which loses the tail
    of every block."""
    n, L = rows.shape
    if L == 0:
        return np.zeros((n, 0), np.uint16), np.zeros(n, np.int64)
    if wire.alphabet < 256 and (rows[:, 1:] >= wire.alphabet).any():
        raise ValueError("a byte past the alphabet after a stream's first")
    per = max(1, min(n, TABLE_BUDGET // (TABLE * wire.alphabet * 4)))
    # One dictionary for every chunk: each chunk's generations start past
    # the last one's, so no entry of an earlier chunk hits.
    table = np.zeros(per * TABLE * wire.alphabet, np.int32)
    codes = np.zeros((n, L), np.uint16)
    counts = np.zeros(n, np.int64)
    gen0 = 0
    for lo in range(0, n, per):
        hi = min(n, lo + per)
        codes[lo:hi], counts[lo:hi], gen0 = _parse_chunk(
            rows[lo:hi], wire, table, gen0)
    if not flush:
        counts -= 1
    return codes, counts


def _parse_chunk(rows: np.ndarray, wire: Wire, table: np.ndarray, gen0: int):
    """Greedy LZW parse of equal-length streams in lockstep.

    The dictionary maps (stream, prefix, byte) to ``tag | code``, the tag
    the stream's generation shifted past the 12 code bits; a reset starts
    a new generation, so nothing is cleared.  A stream's next index grows
    by at most one a step, so the steps between the checks for a full
    table are counted, not tested.  Returns the codes, their counts and
    the last generation used."""
    n, L = rows.shape
    A = wire.alphabet
    cols = rows.T.astype(np.int64)
    base = np.arange(n, dtype=np.int64) * (TABLE * A)
    out = np.zeros(n * L, np.uint16)
    row0 = np.arange(n, dtype=np.int64) * L
    cnt = np.zeros(n, np.int64)
    prefix = cols[0].copy()
    pbase = base + prefix * A
    nxt = np.full(n, wire.first_free, np.int64)
    tag = np.full(n, (gen0 + 1) << MAX_WIDTH, np.int64)
    # The index at which a variable stream resets, or a fixed one freezes.
    full = wire.threshold(MAX_WIDTH) if wire.variable else TABLE
    check = 0
    for t in range(1, L):
        k = cols[t]
        key = pbase + k
        v = table[key]
        hit = (v & -TABLE) == tag
        # A miss emits the prefix; a hit's write is overwritten later.
        out[row0 + cnt] = prefix
        miss = ~hit
        cnt += miss
        add = miss
        reset = None
        if t >= check:
            top = int(nxt.max())
            if top < full:
                check = t + full - top
            else:
                at_full = miss & (nxt >= full)
                add = miss & ~at_full
                if wire.variable:
                    reset = at_full
                check = t + 1
        table[key] = np.where(add, tag | nxt, v)
        nxt += add
        if reset is not None:
            nxt[reset] = wire.first_free
            tag[reset] += TABLE
        prefix = np.where(hit, v & (TABLE - 1), k)
        pbase = base + prefix * A
    out[row0 + cnt] = prefix
    cnt += 1
    return out.reshape(n, L), cnt, int(tag.max()) >> MAX_WIDTH


def _layout(wire: Wire, m_max: int, fix_eoi: bool):
    """The static layout of a stream of at most ``m_max`` data codes.

    Returns (symbols, eoi_off, eoi_w, bits): ``symbols`` the (bit offset,
    width, kind, ordinal) columns i64[4, K] of every symbol but the EOI
    in stream order, kind 0 a CLEAR that every stream has (the leading
    one), 1 data code m, 2 the CLEAR after data code m when a code
    follows; and for a stream of n codes (n = 0..m_max) its EOI's offset
    and width (0 for the fixed flavor, which has none) and its bits."""
    m = np.arange(m_max)
    n = np.arange(m_max + 1)
    if not wire.variable:
        z = np.zeros(m_max + 1, np.int64)
        symbols = np.stack([MAX_WIDTH * m, np.full(m_max, MAX_WIDTH),
                            np.ones(m_max, np.int64), m])
        return symbols, z, z, MAX_WIDTH * n
    pat = epoch_widths(wire)
    P = len(pat)
    widths = pat[n % P]
    clear_after = (n % P) == P - 1
    off = np.zeros(m_max + 1, np.int64)
    off[1:] = np.cumsum(widths + MAX_WIDTH * clear_after)[:m_max]
    off += wire.initial_width
    last = np.maximum(n - 1, 0)
    eoi_off = off[n] - MAX_WIDTH * clear_after[last]
    if fix_eoi:
        eoi_w = np.where(clear_after[last], MAX_WIDTH, widths[n])
    else:
        eoi_w = widths[last]
    eoi_off[0] = eoi_w[0] = wire.initial_width
    cm = m[clear_after[:m_max]]
    cols = [np.array([[0], [wire.initial_width], [0], [0]]),
            np.stack([off[:m_max], widths[:m_max], np.ones(m_max, np.int64),
                      m]),
            np.stack([off[cm] + widths[cm], np.full(len(cm), MAX_WIDTH),
                      np.full(len(cm), 2), cm])]
    symbols = np.concatenate(cols, axis=1)
    symbols = symbols[:, np.argsort(symbols[0], kind="stable")]
    return symbols, eoi_off, eoi_w, eoi_off + eoi_w


def _layers(col: np.ndarray, rows: np.ndarray) -> list:
    """``rows`` (symbols, in order) split so that no two of a part share a
    byte column ``col[rows]``, which rises with the symbol: the first of
    each column's symbols, the second, ...  None stands for all rows in
    one part, the case of codes of 8 bits or more."""
    c = col[rows]
    first = np.flatnonzero(np.diff(c, prepend=-1))
    rank = np.arange(len(c)) - np.repeat(first, np.diff(np.append(first,
                                                                  len(c))))
    top = int(rank.max()) + 1 if len(c) else 0
    if top == 1 and len(rows) == len(col):
        return [None]
    return [rows[rank == r] for r in range(top)]


def pack(codes: np.ndarray, counts: np.ndarray, wire: Wire,
         fix_eoi: bool = True):
    """Wire bytes of each stream: (payloads u8[sum(lengths)] back to back,
    lengths i64[n]).  ``codes`` u16[n, M] and ``counts`` as :func:`parse`
    gives them.

    Every stream has the same layout up to its length, so the symbols
    form a matrix (symbol, stream) with static bit offsets.  A symbol of
    at most 12 bits spans at most three bytes; bytes that several symbols
    touch take the sum of their parts, which is their OR since the bits
    are disjoint."""
    n = len(counts)
    counts = np.asarray(counts, np.int64)
    m_max = int(counts.max()) if n else 0
    symbols, eoi_off, eoi_w, bits = _layout(wire, m_max, fix_eoi)
    off, width, kind, ordinal = symbols
    lengths = (bits[counts] + 7) // 8
    width_b = int(lengths.max()) + 3 if n else 3
    # A symbol is written where the stream has it: data code m when m < n,
    # the CLEAR after code m when m < n - 1, the leading CLEAR always.
    need = np.where(kind == 1, ordinal + 1, np.where(kind == 2, ordinal + 2,
                                                     0))
    clears = np.flatnonzero(kind != 1)
    first_code = np.flatnonzero((kind == 1) & (ordinal == 0))
    at = np.minimum(ordinal, max(m_max - 1, 0))
    b0 = off >> 3
    sh = off & 7
    shift = (sh if wire.little else 24 - width - sh).astype(np.int32)
    every = np.arange(len(off))
    wide = np.flatnonzero(sh + width > 16)
    # (byte lane, symbols that reach it, layers)
    lanes = [(0, every, _layers(b0, every)), (1, every, _layers(b0, every)),
             (2, wide, _layers(b0, wide))]
    out = []
    for lo in range(0, n, LANES):
        hi = min(n, lo + LANES)
        val = codes[lo:hi, :m_max].T[at].astype(np.int32)
        val[clears] = wire.clear
        val[first_code] &= (1 << wire.initial_width) - 1
        val *= need[:, None] <= counts[None, lo:hi]
        val <<= shift[:, None]
        acc = np.zeros((width_b, hi - lo), np.int32)
        for lane, rows, layers in lanes:
            byte_shift = 8 * lane if wire.little else 16 - 8 * lane
            for sub in layers:
                r = rows if sub is None else sub
                part = (val if sub is None else val[r]) >> byte_shift
                part &= 0xFF
                acc[b0[r] + lane] += part
        acc = np.ascontiguousarray(acc.T)
        if wire.variable:
            cc = counts[lo:hi]
            ew = eoi_w[cc]
            x = (wire.eoi & ((1 << ew) - 1)) << (
                eoi_off[cc] & 7 if wire.little
                else 24 - ew - (eoi_off[cc] & 7))
            row = np.arange(hi - lo)
            for lane in range(3):
                byte_shift = 8 * lane if wire.little else 16 - 8 * lane
                acc[row, (eoi_off[cc] >> 3) + lane] += (x >> byte_shift) & 0xFF
        keep = np.arange(width_b)[None, :] < lengths[lo:hi, None]
        out.append(acc[keep].astype(np.uint8))
    payload = np.concatenate(out) if out else np.zeros(0, np.uint8)
    return payload, lengths


def parse_stream(data: bytes, wire: Wire, *, flush: bool = True) -> np.ndarray:
    """The data codes of one stream of ``data``, u16, as :func:`parse`
    gives them for one row (``flush`` as there).  One stream has no
    lanes to advance together, so a Python dictionary keyed by (prefix,
    byte) takes a byte here in a fraction of a lockstep step."""
    if not data:
        return np.zeros(0, np.uint16)
    if wire.alphabet < 256 and (np.frombuffer(data, np.uint8)[1:]
                                >= wire.alphabet).any():
        raise ValueError("a byte past the alphabet after a stream's first")
    # The index at which a variable stream resets, or a fixed one freezes.
    full = wire.threshold(MAX_WIDTH) if wire.variable else TABLE
    table: dict[int, int] = {}
    codes: list[int] = []
    nxt = wire.first_free
    prefix = data[0]
    for byte in data[1:]:
        key = prefix << 8 | byte
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        codes.append(prefix)
        if nxt < full:
            table[key] = nxt
            nxt += 1
        elif wire.variable:
            table.clear()
            nxt = wire.first_free
        prefix = byte
    codes.append(prefix)
    if not flush:
        codes.pop()
    return np.asarray(codes, np.uint16)


def pack_stream(codes: np.ndarray, wire: Wire, fix_eoi: bool = False) -> bytes:
    """The bytes of one stream of data codes (:func:`pack` of one row)."""
    payload, _ = pack(codes[None, :], np.array([len(codes)]), wire, fix_eoi)
    return payload.tobytes()


def encode_stream(data: bytes, wire: Wire, fix_eoi: bool = False, *,
                  flush: bool = True) -> bytes:
    """One stream, salzweg's bytes by default (``fix_eoi=False``)."""
    return pack_stream(parse_stream(data, wire, flush=flush), wire, fix_eoi)


# --------------------------------------------------------------------------- #
# Decode                                                                      #
# --------------------------------------------------------------------------- #


class DecodeError(ValueError):
    """A stream that no encoder of the format writes."""


def decode(payload: np.ndarray, lengths: np.ndarray, wire: Wire) -> np.ndarray:
    """Decode streams (u8 payloads back to back, ``lengths`` bytes each);
    returns their bytes back to back."""
    lengths = np.asarray(lengths, np.int64)
    starts = np.zeros(len(lengths) + 1, np.int64)
    starts[1:] = np.cumsum(lengths)
    outs = []
    for lo in range(0, len(lengths), LANES):
        hi = min(len(lengths), lo + LANES)
        outs.append(_decode_chunk(payload[starts[lo]:starts[hi]],
                                  lengths[lo:hi], wire))
    return np.concatenate(outs) if outs else np.zeros(0, np.uint8)


def _decode_chunk(payload: np.ndarray, lengths: np.ndarray,
                  wire: Wire) -> np.ndarray:
    """Decode streams in lockstep, one code a step.

    Every word is a node: a root (one byte) or an entry (its parent
    word and one byte more).  The steps build the nodes and list each
    stream's words; the bytes are then written from each word's end back
    to its root, one level of every word a step."""
    n = len(lengths)
    starts = np.zeros(n + 1, np.int64)
    starts[1:] = np.cumsum(lengths)
    buf = np.zeros(int(starts[-1]) + 4, np.int64)
    buf[: int(starts[-1])] = payload[: int(starts[-1])]
    bits = lengths * 8
    A = wire.alphabet
    S = int((bits // wire.initial_width).max()) + 1 if n else 1
    n_nodes = A + n * S
    parent = np.full(n_nodes, -1, np.int32)
    suffix = np.zeros(n_nodes, np.uint8)
    length = np.ones(n_nodes, np.int32)
    first = np.zeros(n_nodes, np.uint8)
    suffix[:A] = first[:A] = np.arange(A)
    node_of = np.zeros(n * TABLE, np.int64)
    lane = np.arange(n, dtype=np.int64)
    words = np.zeros(n * S, np.int32)
    n_words = np.zeros(n, np.int64)
    pos = np.zeros(n, np.int64)
    width = np.full(n, wire.initial_width, np.int64)
    nxt = np.full(n, wire.first_free, np.int64)
    prev = np.full(n, -1, np.int64)
    done = lengths == 0 if wire.variable else np.zeros(n, bool)
    for t in range(S):
        if done.all():
            break
        short = pos + width > bits
        if wire.variable and (short & ~done).any():
            raise DecodeError("a stream ends before its EOI")
        done |= short
        live = ~done
        b = starts[:-1] + (pos >> 3)
        s = pos & 7
        if wire.little:
            win = buf[b] | (buf[b + 1] << 8) | (buf[b + 2] << 16)
            code = (win >> s) & ((1 << width) - 1)
        else:
            win = (buf[b] << 16) | (buf[b + 1] << 8) | buf[b + 2]
            code = (win >> (24 - width - s)) & ((1 << width) - 1)
        pos += np.where(live, width, 0)
        data = live
        if wire.variable:
            clear = live & (code == wire.clear)
            eoi = live & (code == wire.eoi)
            done |= eoi
            data = live & ~clear & ~eoi
            width[clear] = wire.initial_width
            nxt[clear] = wire.first_free
            prev[clear] = -1
        fresh = data & (prev < 0)
        if (fresh & (code >= A)).any():
            raise DecodeError("a first code after a reset is not a byte")
        kwk = data & ~fresh & (code == nxt)
        if (data & ~fresh & ((code > nxt) | ((code >= A) & (code < wire.first_free)))).any():
            raise DecodeError("a code past the dictionary")
        new = A + lane * S + t
        known = node_of[lane * TABLE + np.minimum(code, TABLE - 1)]
        occ = np.where(code < A, code, np.where(kwk, new, known))
        p = np.maximum(prev, 0)
        head = np.where(kwk, first[p], first[np.where(kwk, 0, occ)])
        make = data & ~fresh & (nxt < TABLE)
        if wire.variable and (data & ~fresh & (nxt >= TABLE)).any():
            raise DecodeError("a full table without a CLEAR")
        idx = new[make]
        parent[idx] = prev[make]
        suffix[idx] = head[make]
        length[idx] = length[p[make]] + 1
        first[idx] = first[p[make]]
        node_of[lane[make] * TABLE + nxt[make]] = idx
        nxt += make
        if wire.variable:
            bump = make & (nxt == ((1 << width) - int(wire.early_change))) & (
                width < MAX_WIDTH)
            width += bump
        words[lane * S + n_words] = occ
        n_words += data
        prev = np.where(data, occ, prev)
    if not done.all() and wire.variable:
        raise DecodeError("a stream without an EOI")
    keep = np.arange(S)[None, :] < n_words[:, None]
    occ = words.reshape(n, S)[keep]
    ends = np.cumsum(length[occ], dtype=np.int64)
    out = np.zeros(int(ends[-1]) if len(ends) else 0, np.uint8)
    at = ends - 1
    node = occ
    while node.size:
        out[at] = suffix[node]
        node = parent[node]
        at = at - 1
        more = node >= 0
        node, at = node[more], at[more]
    return out

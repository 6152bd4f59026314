"""Frozen copy of the hashing tokenizer the configurations state: lowercase,
split into runs of letters, runs of digits and single other characters,
hash each piece with 8-byte blake2b into ``[2, vocab)``, prepend the CLS
id 1 and cut at ``max_len``. Pad id 0."""

from __future__ import annotations

import hashlib
import re
import struct

_PIECE = re.compile(r"[a-zA-Z]+|\d+|[^\sa-zA-Z\d]")
CLS_ID = 1
RESERVED = 2


def piece_id(piece: str, vocab_size: int) -> int:
    h = struct.unpack("<Q", hashlib.blake2b(piece.encode(), digest_size=8).digest())[0]
    return RESERVED + h % (vocab_size - RESERVED)


def encode(text: str, vocab_size: int, max_len: int, memo: dict | None = None) -> list[int]:
    """Token ids of ``text``; ``memo`` (piece -> id) saves rehashing."""
    ids = [CLS_ID]
    for piece in _PIECE.findall(text.lower()):
        if memo is None:
            ids.append(piece_id(piece, vocab_size))
            continue
        i = memo.get(piece)
        if i is None:
            i = memo[piece] = piece_id(piece, vocab_size)
        ids.append(i)
    return ids[:max_len]

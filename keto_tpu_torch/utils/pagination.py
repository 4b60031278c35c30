"""Opaque pagination tokens (counterpart of ``keto_tpu/utils/pagination.py``).

Tokens are opaque url-safe strings encoding a result offset; the empty
string means "first page" / "no more pages", and malformed tokens map to
ErrMalformedPageToken (reference internal/x/pagination.go).
"""

from __future__ import annotations

import base64
import binascii
from dataclasses import dataclass

from .errors import ErrMalformedPageToken

DEFAULT_PAGE_SIZE = 100  # reference internal/persistence/sql/persister.go:45-47


@dataclass
class PaginationOptions:
    token: str = ""
    size: int = 0

    @property
    def per_page(self) -> int:
        return self.size if self.size > 0 else DEFAULT_PAGE_SIZE


def encode_page_token(offset: int) -> str:
    """Encode an offset as an opaque url-safe token. Offset 0 -> "" (first page)."""
    if offset <= 0:
        return ""
    raw = str(offset).encode()
    return base64.urlsafe_b64encode(raw).decode().rstrip("=")


def decode_page_token(token: str) -> int:
    """Decode a token back to an offset; '' -> 0. Raises ErrMalformedPageToken."""
    if not token:
        return 0
    try:
        pad = "=" * (-len(token) % 4)
        raw = base64.urlsafe_b64decode(token + pad)
        offset = int(raw.decode())
    except (binascii.Error, UnicodeDecodeError, ValueError) as e:
        raise ErrMalformedPageToken() from e
    if offset < 0:
        raise ErrMalformedPageToken()
    return offset

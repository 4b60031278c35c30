"""Continuation tokens for the paged read surfaces (counterpart of
``keto_tpu/engine/paging.py``).

Expand paging (``engine/expand.py``, ``engine/device.py``) and list paging
(``engine/listing.py``) cut version-pinned cursors with one failure
contract:

- garbage / truncated / non-JSON token        -> ErrMalformedPageToken (400)
- token minted by a different engine flavor   -> ErrMalformedPageToken (400)
- token pinned to a superseded data version   -> ErrStalePageToken (409)

The cursor is base64url(compact JSON) of ``{"k": kind, "v": version, ...}``
plus engine-specific payload keys: the same bytes as ``keto_tpu`` mints, so
a token from either package opens in the other.
"""

from __future__ import annotations

import base64
import json

from ..utils.errors import ErrMalformedPageToken, ErrStalePageToken


def encode_page_token(kind: str, version, payload: dict) -> str:
    """Mint a cursor: ``payload`` keys ride next to the ``k``/``v`` pin
    (they must not collide with those two names)."""
    doc = {"k": kind, "v": version, **payload}
    raw = json.dumps(doc, separators=(",", ":")).encode()
    return base64.urlsafe_b64encode(raw).decode()


def decode_page_token(
    token: str, kind: str, version, what: str = "page"
) -> dict:
    """Validate and open a cursor -> its full payload dict. ``what`` names
    the surface in error text ("expand page", "list page")."""
    try:
        payload = json.loads(base64.urlsafe_b64decode(token.encode()))
        got_kind = payload["k"]
        got_version = payload["v"]
    except Exception as e:
        raise ErrMalformedPageToken(f"malformed {what} token") from e
    if got_kind != kind:
        raise ErrMalformedPageToken(
            f"{what} token was issued by a {got_kind!r} engine"
        )
    if got_version != version:
        raise ErrStalePageToken(
            f"{what} token expired: issued at version {got_version}, "
            f"serving {version}"
        )
    return payload

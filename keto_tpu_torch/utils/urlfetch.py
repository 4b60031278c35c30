"""One HTTP request on ``urllib.request``, a new connection each time.

The one-shot helper behind the vocab cache's sync requests, ``post_frame``
and the timed drives' client processes (``poolharness.client_main``).
Standard library only, so a client process that imports it starts without
torch. A caller that sends many requests to one server wants
``keto_tpu_torch.client.RestClient`` instead, which keeps its connection.
"""

from __future__ import annotations

import urllib.error
import urllib.request
from typing import Optional


def fetch(url: str, data: Optional[bytes] = None, headers: Optional[dict] = None,
          timeout: float = 120.0, method: Optional[str] = None):
    """(status, body bytes, response headers) of one request: GET without
    ``data``, POST with it, unless ``method`` says otherwise. An HTTP error
    status is an answer, not an exception."""
    req = urllib.request.Request(
        url, data=data, headers=headers or {},
        method=method or ("GET" if data is None else "POST"),
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers

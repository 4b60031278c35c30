"""One HTTP request on ``urllib.request``, a new connection each time.

The one-shot helper behind the vocab cache's sync requests, ``post_frame``
and the timed drives' client processes (``poolharness.client_main``).
Standard library only, so a client process that imports it starts without
torch. A caller that sends many requests to one server wants
``keto_tpu_torch.client.RestClient`` instead, which keeps its connection.

``verify`` takes what httpx's does: True (the system's CAs), False (no
verification), a CA bundle file or directory, or an ``ssl.SSLContext``.
"""

from __future__ import annotations

import os
import ssl
import urllib.error
import urllib.request
from typing import Optional


def ssl_context(verify=True) -> ssl.SSLContext:
    """The client context an https request uses under ``verify``."""
    if isinstance(verify, ssl.SSLContext):
        return verify
    if verify is True:
        return ssl.create_default_context()
    if verify is False:
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        return ctx
    path = os.fspath(verify)
    if os.path.isdir(path):
        return ssl.create_default_context(capath=path)
    return ssl.create_default_context(cafile=path)


def fetch(url: str, data: Optional[bytes] = None, headers: Optional[dict] = None,
          timeout: float = 120.0, method: Optional[str] = None, verify=True):
    """(status, body bytes, response headers) of one request: GET without
    ``data``, POST with it, unless ``method`` says otherwise. An HTTP error
    status is an answer, not an exception."""
    req = urllib.request.Request(
        url, data=data, headers=headers or {},
        method=method or ("GET" if data is None else "POST"),
    )
    context = ssl_context(verify) if url.startswith("https:") else None
    try:
        with urllib.request.urlopen(req, timeout=timeout, context=context) as resp:
            return resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers

"""Best-effort completion notifier (a copy of ``gims_tpu/core/notify.py``).

The reference pings a hard-coded WeChat webhook when an evaluation run
finishes or a parameter sweep errors (reference: utils/common.py:831-835,
called from eval_homography.py:268, eval_matches.py:181,
tools/parameter_search.py:206-209). The TPU build keeps the capability
but makes the endpoint configurable: set GIMS_NOTIFY_URL to any HTTP(S)
endpoint and `send_notify(msg)` GETs it with the message attached as the
`msg` query parameter. Unset (the default, and always in this zero-egress
environment) it is a no-op. Failures are swallowed — notification must
never take down a run.
"""

from __future__ import annotations

import os
import urllib.parse
import urllib.request

__all__ = ["send_notify"]


def send_notify(msg: str, timeout: float = 5.0) -> bool:
    """GET $GIMS_NOTIFY_URL with ?msg=<quoted msg>. Returns True iff a
    request was attempted and got any HTTP response."""
    url = os.environ.get("GIMS_NOTIFY_URL", "")
    if not url:
        return False
    sep = "&" if "?" in url else "?"
    full = url + sep + "msg=" + urllib.parse.quote(str(msg)[:2000])
    try:
        with urllib.request.urlopen(full, timeout=timeout):
            return True
    except Exception:  # noqa: BLE001 — best-effort by contract
        return False

"""The serving fleet's replica-target key and its decoder.

The port's copy of :func:`read_target` from the JAX package's
``fleet/scheduler.py``, with the key it decodes.  The key has three
on-wire forms: a raw int (an operator's out-of-band override, which
beats every other writer), a seq-guarded JSON doc ``{"target": n,
"seq": k, "writer": ...}`` (written by a fleet scheduler or a routed
controller hint), and anything else, which never scales a fleet.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

__all__ = ["TARGET_KV_KEY", "read_target"]

TARGET_KV_KEY = "/serve/target_replicas"


def read_target(raw: Optional[bytes]) -> Optional[Dict[str, Any]]:
    """Decode the ``/serve/target_replicas`` value into a uniform doc.

    Three on-wire forms, by precedence at the reader:

    * raw int (``b"3"``) — the operator's out-of-band override
      (``seq`` is None: it beats every doc writer);
    * JSON doc ``{"target": n, "seq": k, "writer": ...}`` — the
      fleet scheduler / routed controller hint, seq-guarded;
    * anything else — None (garbage never scales a fleet).
    """
    if raw is None:
        return None
    try:
        text = raw.decode()
    except UnicodeDecodeError:
        return None
    try:
        return {"target": int(text), "seq": None, "writer": "operator"}
    except ValueError:
        pass
    try:
        doc = json.loads(text)
    except ValueError:
        return None
    if not isinstance(doc, dict) or "target" not in doc:
        return None
    try:
        doc["target"] = int(doc["target"])
    except (TypeError, ValueError):
        return None
    return doc

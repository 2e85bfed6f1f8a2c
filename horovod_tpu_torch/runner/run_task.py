"""Worker-side entry for the programmatic ``hvd.run`` API.

Fetches the pickled function from the launcher's KV store, executes it,
posts the pickled result keyed by rank (ref: runner/run_task.py +
task_fn.py — same exec-pickled-fn contract, HTTP KV instead of the
pickle-RPC task service).
"""

from __future__ import annotations

import os
import pickle
import sys


def main() -> int:
    from .http_kv import KVClient

    client = KVClient(os.environ["HVDT_RUNFUNC_ADDR"],
                      int(os.environ["HVDT_RUNFUNC_PORT"]),
                      bytes.fromhex(os.environ["HVDT_RUNFUNC_SECRET"]))
    fn = pickle.loads(client.wait("/runfunc/fn", timeout=60.0))
    rank = int(os.environ.get("HVDT_RANK", 0))
    result = fn()
    client.put(f"/runfunc/result/{rank}", pickle.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

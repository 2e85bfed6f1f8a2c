"""Elastic launcher: discovery, driver, worker registration.

The port's counterpart of the JAX package's ``runner/elastic/`` (Horovod's
runner/elastic/: driver.py, discovery.py, registration.py, worker.py):
the driver discovers hosts with a user script, recomputes slot
assignments on change, publishes them to the rendezvous KV with a bumped
version, and respawns every slot each generation; workers resume through
the in-training State commit/restore machine
(``horovod_tpu_torch.elastic``).
"""

from .discovery import HostManager, HostState  # noqa: F401
from .driver import ElasticDriver, run_elastic  # noqa: F401
from .registration import WorkerStateRegistry  # noqa: F401

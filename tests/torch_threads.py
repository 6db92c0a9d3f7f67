"""Share the CPU among the test processes.

Torch runs its CPU ops on as many threads as the machine has cores.
Under pytest-xdist every worker does so, and six workers at eight
threads each on an eight-core machine spend their time switching
threads.  Each tests/test_torch_*.py module calls `cap_torch_threads`
at import: the cores divided among the workers
(PYTEST_XDIST_WORKER_COUNT; one worker without xdist), at least one
thread each.
"""

import os

import torch


def cap_torch_threads() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    threads = max(1, (os.cpu_count() or 1) // max(workers, 1))
    torch.set_num_threads(threads)
    return threads

"""The benchmark of the PyTorch/CUDA port (``audiosignalprocess_tpu_torch``).

``python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once (``portbench.harness``).  The
clock of the run's set-up starts here, with the process.
"""

import os
import time

START_PERF = time.perf_counter()


def _age_s() -> float:
    """Seconds since this process started (0.01 s resolution), 0 where
    /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(0.0, up - started / os.sysconf("SC_CLK_TCK"))


START_AGE_S = _age_s()

"""The benchmark's command, run from the root of a checkout:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the run's result as one JSON object;
the last lines of standard error are the numbers that decide `correct`,
each beside its limit. Without CUDA, without the cards the cell asks for,
without the program in the checkout, or when the window loaded JAX, it
exits non-zero and prints no result.
"""

import os
import time


def _process_age_s() -> float:
    """Seconds since this process started (Linux; 0.0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


#: the process's start on the monotonic clock: set-up is timed from here
T0 = time.monotonic() - _process_age_s()

# One process with one host thread for math: the cells' host work is small,
# and idle OpenMP and BLAS pools only add run-to-run noise.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = Path.cwd().resolve()

    from benchmark import harness

    try:
        import quantpy_tpu_torch
    except ImportError as e:
        harness.log(f"no result: the program cannot be imported ({e})")
        return 2
    if Path(quantpy_tpu_torch.__file__).resolve().parents[1] != root:
        harness.log(f"no result: quantpy_tpu_torch comes from {quantpy_tpu_torch.__file__}, "
                    f"not from the checkout at {root}")
        return 2
    try:
        result = harness.run(root, args.workload, args.seed, args.seconds, bool(args.trace), T0)
    except harness.NoDevice as e:
        harness.log(f"no result: {e}")
        return 3
    except harness.ForbiddenModules as e:
        harness.log(f"no result: {e}")
        return 4
    for name, check in result["checks"].items():
        harness.log(f"check {name} = {check['value']!r} (limit {check['limit']!r})")
        check["value"] = _finite(check["value"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's benchmark: one run of one cell on its H100s (the first
``chips`` visible cards).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout of the repository; the cells are those
of ``BENCHMARK.json``.  The program under test is ``src/repro_torch``;
its kernel libraries and its characterization cache are built into
``build/`` inside the checkout on the first run.  The last line of
standard output is the result as one JSON object; the numbers the
correctness check compared, each with its limit, are the last lines of
standard error.  Exits non-zero, printing no result, without a CUDA
device or without the program.
"""
import os
import sys
import time

T_START = time.perf_counter()

import shutil  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    work = Path(tempfile.mkdtemp(prefix="portbench-"))
    # the program's AUTO knobs resolve through an autotune cache: a fresh,
    # empty one gives its own defaults, whatever the machine holds
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(work / "autotune.json")
    os.environ["REPRO_TORCH_AUTOTUNE"] = "0"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    try:
        from portbench import harness
        return harness.main(sys.argv[1:], T_START, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())

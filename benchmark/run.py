"""Run one benchmark cell once and print its result as the last line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

The cell is the entry of ``workloads`` in BENCHMARK.json; everything it
needs is found by name under this directory (README.md). The run needs
as many CUDA cards as the cell asks for and fails without them.
"""

import time

T_START = time.perf_counter()   # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Every build and kernel cache at a fixed path inside the checkout, given
# before torch is imported, so that only a checkout's first run builds.
_CACHE = os.path.join(ROOT, "build", "bench_cache")
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(_CACHE, _sub)

if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path.pop(0)
sys.path.insert(0, ROOT)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))

"""Run one cell of the sfvp_tpu_torch benchmark once, from the root of a
checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cells, their configurations, traffic mixes and metrics are named in
BENCHMARK.json; the last line of standard output is the result as one
JSON object. The program's build caches stay inside the checkout
(build/), so only a checkout's first run compiles: the kernel library,
the Triton and extension caches, and the bytecode of every Python module
the run imports (torch's included, which an installation may ship
without and an interpreter may be told not to write).
"""

import os
import sys
from pathlib import Path

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parent.parent
    sys.path[0] = str(ROOT)
    build = ROOT / "build"
    sys.pycache_prefix = str(build / "pycache")
    sys.dont_write_bytecode = False
    os.environ["SFVP_TPU_TORCH_BUILD_DIR"] = str(build / "sfvp_tpu_torch")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    from portbench.harness import main

    sys.exit(main())

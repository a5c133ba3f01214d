#!/usr/bin/env python3
"""Run one benchmark cell once, on the card(s) of this machine.

    python3 benchmark/run.py --workload serve.sweep256 --seed 7 --seconds 20 --trace 0

Prints the result as the last line of standard output (``README.md``).
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    # caches of the program and of PyTorch at fixed paths inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ.setdefault(var, str(ROOT / "benchmark" / ".cache" / sub))
    sys.path[0] = str(ROOT)
    from benchmark.harness.main import main

    sys.exit(main())

"""Run one cell of the port's benchmark on the card this process sees.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout of the repository. Prints the result as one
JSON line, the last of standard output; see ``portbench/harness.py``.
"""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and kernel caches at fixed paths inside the checkout (the system's
# own kernel library builds under build/repro_torch by itself).
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

if __name__ == "__main__":
    from portbench import harness

    harness.main(sys.argv[1:], T_START)

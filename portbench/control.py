"""Run one cell with its control in place of the system's outputs: the
plain reference computed in bfloat16, the precision below the float32
the configurations state. Everything else is the cell's own run (set-up,
window, the same comparison); ``correct`` must come out false.

    python3 portbench/control.py --workload <cell> --seed <n> \
        --seconds <s> --trace 0

From the root of a checkout, on the card; the benchmark's own runs never
run it.
"""
import os
import sys
import time

T_START = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import run  # noqa: E402  (sets the caches and the import path)

if __name__ == "__main__":
    from portbench import harness

    harness.main(sys.argv[1:], T_START, control=True)

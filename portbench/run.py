"""Run one benchmark cell once and print its result line:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. See portbench/harness.py.
"""
import sys
import time

T_START = time.perf_counter()  # set-up counts from here, imports included

if __name__ == "__main__":
    from portbench.harness import main

    sys.exit(main(t_start=T_START))

"""The harness's tests: its modules and the program at the checkout's root
on the path, as `port_bench/run.py` puts them."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent), str(HERE.parents[1])]

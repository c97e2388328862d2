"""``python3 -m perfbench``: one run of one cell (see ``perfbench/run.py``)."""

import time

T_START = time.monotonic()  # set-up is counted from here

import sys  # noqa: E402

from perfbench.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], t_start=T_START))

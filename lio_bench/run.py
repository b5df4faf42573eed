"""One run of one cell of the port's benchmark:

    python3 lio_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

prints one JSON object as its last line of standard output (see
lio_bench/README.md). Runs only where a CUDA card is visible.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lio_bench.harness.cell import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())

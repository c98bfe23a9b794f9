import time

_T0 = time.perf_counter()   # set-up is counted from here, before any import

import sys  # noqa: E402

from wsod_bench.run import main  # noqa: E402

sys.exit(main(t0=_T0))

#!/usr/bin/env python3
"""Run one cell of the benchmark on the card this process sees.

    python benchmark/run.py --workload offline-demo1.motion-drop \
        --seed 12345 --seconds 40 --trace 0

From the root of a checkout.  Prints, on standard output, the seconds of
each phase and then, as its last line, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1`` also
``breakdown``) and last ``check``, each number compared beside its limit.
Standard error ends with the same comparison.  Exits non-zero and prints no
result without a CUDA device, with fewer devices than the cell asks for,
when the traced stretch dropped kernel launches, or when JAX or the JAX
package was imported.
"""

import time

PROCESS_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import main

    sys.exit(main(sys.argv[1:], PROCESS_START))

"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The program under test is the PyTorch and CUDA
package under ``src/``; see ``bench/harness.py``.
"""
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [_ROOT, os.path.join(_ROOT, "src")] + [
    p for p in sys.path[1:] if os.path.abspath(p or ".") != _ROOT]

from bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())

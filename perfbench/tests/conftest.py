"""The benchmark's own tests: the checkout's root on the import path, so
that `perfbench` and the program import from any working directory."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

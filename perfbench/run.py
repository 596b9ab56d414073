"""Entry point of the benchmark of xrsfm_tpu_torch, the PyTorch and CUDA
port.  Run from the root of a checkout:

  python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
      --trace <0|1>

The cells are BENCHMARK.json's workloads; perfbench/README.md says what a
run does and how a cell, a traffic mix or a metric is added.

Caches of compiled code stay inside the checkout at fixed paths: the
port's own kernels build into build/kernels/ (xrsfm_tpu_torch/kernels/
build.py), and Triton's, torch extensions' and the CUDA driver's caches go
under build/perfbench/.  Host threads are capped at four, so that one run
leaves the rest of the machine's cores alone.  The run starts itself anew
with PYTHONHASHSEED fixed, so that one seed gives one order of work in
every process.
"""

import os
import sys

if __name__ == "__main__" and os.environ.get("PYTHONHASHSEED") != "0":
    os.environ["PYTHONHASHSEED"] = "0"
    os.execv(sys.executable, [sys.executable] + sys.argv)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE = os.path.join(ROOT, "build", "perfbench")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "cuda")
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "4"
# the checkout's root, not this folder, heads the import path
sys.path[0] = ROOT

if __name__ == "__main__":
    from perfbench.lib import harness

    sys.exit(harness.main(sys.argv[1:]))

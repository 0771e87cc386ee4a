import os
import sys

# smoke tests and benches must see the REAL device count (1 CPU device) —
# the 512-device XLA flag is set ONLY inside launch/dryrun.py.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and the CUDA toolkit (nvcc); "
        "skips where there is none")

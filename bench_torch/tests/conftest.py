"""The benchmark's modules (`bench_torch/`) and the repository's root on
`sys.path` for the tests here. pytest puts this folder there itself, so
`faults` imports as it is."""
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

"""The benchmark of graphlily_tpu_torch on one NVIDIA card.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of `BENCHMARK.json` once, from the root of a checkout:
set-up, a measured window of `--seconds`, then the comparison with the
plain reference. The last line of standard output is one JSON object
(`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
also `breakdown`, and last `checks`: each number compared with its
limit); the last lines of standard error repeat the checks. Without a
card, or with fewer cards than the cell asks for, it prints no result
and exits with 2; where the process has loaded JAX or the JAX package
by the time the comparison is done, it names what it found on standard
error, prints no result and exits with 3.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

# top-level modules that the process printing a result may not hold: JAX
# and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "graphlily_tpu")


def forbidden_modules() -> list:
    """The names of `FORBIDDEN` that `sys.modules` holds, compared by
    whole top-level name (`graphlily_tpu_torch` is not `graphlily_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    import harness
    import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} CUDA card(s); "
                    f"this machine has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    threads = cell.config.get("host", {}).get("torch_threads")
    if threads is not None:             # the deployment's host setting
        torch.set_num_threads(int(threads))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    harness.log(f"card: {harness.card_line()}; torch {torch.__version__}, "
                f"CUDA {torch.version.cuda}; {args.workload} seed {args.seed} "
                f"seconds {args.seconds} trace {args.trace}")
    result, lines = harness.run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace), torch.device("cuda"),
                                     T_START)
    found = forbidden_modules()
    if found:
        harness.log(f"no result: this process loaded {', '.join(found)}")
        return 3
    emit(result, lines)
    return 0


def emit(result: dict, lines: list) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())

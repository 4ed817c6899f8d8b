"""The control of a cell's comparison: the plain reference put in the
program's place, run in each mode that the cell's reference declares, at
the cell's own size and sample. The reference's `CONTROLS` are the modes
whose numbers have to fail the cell's limits: for a float reference, the
step below the precision the configuration states (TF32 for its
float32); for an exact one, a mode of its own, such as stopping one hop
short of the deepest level reached. Its `SOUND` modes, such as a plain
float32 run of the same reference, have to be within them.

    python3 bench_torch/control.py --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line per seed and mode, with its role, "control" or
"sound". `--modes` replaces the reference's `CONTROLS` and `SOUND`; a
mode given there that the reference declares in neither has the role
null. Needs a card, as a run does.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]


def control(cell, seed: int, modes, device, scale=None) -> list:
    """One record per mode: its role, the numbers compared and whether
    each is within its limit. A mode that the reference declares in
    neither `CONTROLS` nor `SOUND` has the role None."""
    import torch

    import graph as graphs

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    graph = graphs.make(cell.config, gen, device, scale)
    queries = cell.entry.queries(graph, cell.config, cell.traffic, gen)
    k = int(cell.traffic["sample"])
    checked = (queries * k)[:k]
    args = (graph, cell.config, cell.traffic, checked)
    want = cell.reference.solve(*args, "float64", device)
    limits = cell.workload["limits"]
    out = []
    for mode in modes:
        t = time.perf_counter()
        got = cell.reference.solve(*args, mode, device)
        checks = cell.reference.compare(got, want, cell.traffic)
        role = ("control" if mode in cell.reference.CONTROLS
                else "sound" if mode in cell.reference.SOUND else None)
        out.append({"workload": cell.name, "seed": seed, "mode": mode,
                    "role": role, "checks": checks,
                    "within": {c: checks[c] <= limits[c] for c in checks},
                    "seconds": time.perf_counter() - t})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--modes", nargs="+")
    args = p.parse_args(argv)

    import torch

    import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    modes = args.modes or cell.reference.CONTROLS + cell.reference.SOUND
    for seed in args.seeds:
        for rec in control(cell, seed, modes, torch.device("cuda")):
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

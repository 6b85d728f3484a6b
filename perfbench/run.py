"""Run one cell of the path tracer's benchmark once, on the card.

    python3 perfbench/run.py --workload readme.render --seed 7 \
        --seconds 10 --trace 0

Loads the cell's scene, warms up, measures for ``--seconds``, checks what
the measured path produced against the plain reference in
``perfbench/reference/``, and prints one JSON line last: with ``--trace
0`` the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics from a device trace of the window.  Without enough CUDA devices
it exits 2 and prints no result.  The cells, configurations and metrics
are files under ``perfbench/``, found by the names in ``BENCHMARK.json``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness
    return harness.main(ROOT, args.workload, args.seed, args.seconds,
                        bool(args.trace), T0)


if __name__ == "__main__":
    sys.exit(main())

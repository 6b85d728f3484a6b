"""Upper readings of a cell's compared numbers, on the card: the control
and the faults, each put in the program's place and compared as a run
compares the program.

    python3 perfbench/calibrate.py --workload readme.render --seeds 1,2,3

For each seed, the inputs that a run of that seed uses, and then:

- the control, the reference computed in bfloat16, the nearest precision
  below the configuration's float32;
- render cells: the reference at half the samples (half of the batch left
  out, the mean taken over the rest), and its image with 0.05 added to
  the red channel (an answer altered where it is produced);
- fit cells: the reference's step with every other block of pixels left
  out of the gradient and the rest scaled to the whole image (half of the
  batch left out), and the step with its image scaled by 1.1 where it is
  rendered (an answer altered).  A step that leaves the state unchanged
  reads 1 in ``step_gap`` by its definition and needs no run.

One JSON line a seed and reading.  The limits in the workload files lie
between these readings and the largest that sound runs of the program
give (the checks that ``run.py`` prints).
"""

import argparse
import dataclasses
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the altered answer of a render: added to each pixel
ALTER = (0.05, 0.0, 0.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import harness
    from perfbench.entries import fit, render

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    spec = harness.load_cell(ROOT, args.workload)
    params = spec["workload"]["params"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if spec["workload"]["entry"] == "render":
            inp = render.inputs(spec["config"], params, seed)
            half = dict(inp, rs=dataclasses.replace(
                inp["rs"], spp=max(1, inp["rs"].spp // 2)))
            for k in inp["check"]:
                want = render.reference_rows(inp, k, device)
                emit(args.workload, seed, k, t0, {
                    "control_bf16": render.mean_abs(render.reference_rows(
                        inp, k, device, dtype=torch.bfloat16), want),
                    "half_samples": render.mean_abs(render.reference_rows(
                        half, k, device), want),
                    "answer_altered": render.mean_abs(
                        want + torch.tensor(ALTER, device=device), want)})
        else:
            inp = fit.inputs(spec["config"], params, seed, device)
            want = fit.reference_step(inp, device)
            emit(args.workload, seed, 0, t0, {
                "control_bf16": fit.compare(inp, fit.reference_step(
                    inp, device, dtype=torch.bfloat16), want),
                "half_batch": fit.compare(inp, fit.reference_step(
                    inp, device, keep_blocks=lambda i: i % 2 == 0), want),
                "answer_altered": fit.compare(inp, fit.reference_step(
                    inp, device, image_fn=lambda img: img * 1.1), want)})
    return 0


def emit(cell, seed, item, t0, readings):
    print(json.dumps({"workload": cell, "seed": seed, "item": item,
                      "seconds": time.perf_counter() - t0,
                      "readings": readings}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

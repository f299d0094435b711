"""The readings the limits of `correct` are set from, for one cell.

    python3 pmbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control 4,5,6]

For each of --seeds, one pass of the cell's timed path through its entry
(pmbench/entries/<entry>.py) from that seed's inputs, compared with the
entry's reference (the lower readings); for each of --control, the
entry's control (the upper readings, which have to fail). One JSON line
a reading, and the largest sound and least control value of each number
last. Runs on the card at the cell's own size, everything in one
process.
"""

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    args = ap.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    import torch
    from pmbench import harness

    cell = harness.load_cell(args.workload)
    params, ref_params = harness.params(cell)
    dev = torch.device("cuda")
    sound, control = {}, {}

    def note(kind, seed, values, into):
        for k, v in values.items():
            into[k] = max(into.get(k, v), v) if kind == "sound" else \
                min(into.get(k, v), v)
        print(json.dumps(dict(kind=kind, seed=seed, **values)), flush=True)

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        mix = cell.entry.Mix(params, ref_params, seed, dev, False,
                             cell.traffic)
        mix.run_pass()
        mix.finish()
        gc.collect()
        torch.cuda.empty_cache()
        note("sound", seed, mix.compare(), sound)
        del mix
    for seed in [int(s) for s in args.control.split(",") if s]:
        note("control", seed, cell.entry.control(ref_params, seed, dev),
             control)
    print(json.dumps(dict(kind="summary", workload=args.workload,
                          largest_sound=sound, least_control=control)))


if __name__ == "__main__":
    main()

"""Run one cell of the benchmark of fastpm_torch once.

    python3 pmbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is the result: a JSON object with
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with --trace 1 its per-layer metrics), `device` and, traced,
`breakdown`; then `setup_phases` (set-up seconds by phase) and, last,
`limits`: every number compared with the reference beside its limit,
which the last lines of standard error repeat. Exits non-zero, with no result, where there is no card or
too few, or where jax, jaxlib, flax or fastpm_tpu was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    # the card's JIT cache at a fixed place inside the checkout; the
    # program builds its kernels into build/fastpm_torch there itself
    os.environ["CUDA_CACHE_PATH"] = os.path.join(ROOT, "build", "cuda_cache")

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = {w["name"]: w for w in json.load(f)["workloads"]}
    if args.workload not in cells:
        print(f"pmbench: unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"pmbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3

    from pmbench import harness
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda", t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        print("pmbench: the run loaded " + ", ".join(bad), file=sys.stderr)
        return 4
    for name, v in result["limits"].items():
        print(f"pmbench: {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

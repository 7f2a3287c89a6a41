"""The readings a cell's limits are set from, at the cell's own size on the
card. The benchmark's runs do not run this.

    python3 perfbench/calibrate.py --workload <cell> --program-seeds 1,2,... \\
        --control-seeds 7,8,9 [--out chiprun_out/calibrate.json]

- program: the program's checked steps (the run's own set-up, call and
  feed, on every rank the cell has) against the float32 reference, one seed
  after another in one process a rank;
- control: the reference in float8 (``precision="fp8"``), the nearest
  precision below the configuration's bfloat16, put in the program's place;
- faults, planted in the reference put in the program's place: half of each
  rank's rows left out and the mean taken over the rest
  (``half_batch``); on several ranks, each update from rank 0's rows alone,
  the exchange between ranks left out (``no_exchange``). A step that leaves
  the state unchanged reads 1 by the leaf numbers and needs no run.

Prints one JSON object of every reading, by kind and seed.
"""

from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def _first_batches(spec: dict, seed: int) -> list:
    from perfbench import traffic as traffic_gen
    from perfbench.harness import CHECKED_STEPS, Source

    source = Source(traffic_gen.make_pool(spec["traffic"], spec["config"], seed),
                    spec["traffic"], 0, seed)
    list(itertools.islice(iter(source), CHECKED_STEPS))
    return source.first


def planted(spec: dict, seed: int, dev, precision: str = "float32", fault: str | None = None):
    """The reference's readings of ``seed`` in ``precision``, with ``fault``
    planted."""
    import torch

    from perfbench.harness import reference_readings

    rows_of = None
    if fault == "half_batch":
        def rows_of(rank, n):
            return torch.arange(n // 2)
    elif fault == "no_exchange":
        def rows_of(rank, n):
            return torch.arange(n) if rank == 0 else torch.arange(0)
    return reference_readings(spec["config"], spec["traffic"], _first_batches(spec, seed), seed,
                              dev, precision, rows_of)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--program-seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)

    import torch

    from perfbench import compare, manifest
    from perfbench.harness import run_rank

    if not torch.cuda.is_available():
        print("calibration needs a CUDA card", file=sys.stderr)
        return 2
    spec = manifest.cell(args.workload)
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.program_seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    out: dict = {"workload": args.workload, "card": torch.cuda.get_device_name(dev),
                 "program": {}, "control": {}, "half_batch": {}, "no_exchange": {}}

    def record(kind, seed, values, where, seconds):
        out[kind][seed] = {"numbers": values, "where": where, "seconds": seconds}
        print(f"{kind} seed {seed}: " + ", ".join(f"{k} {v:.6g} ({where[k]})"
                                                 for k, v in values.items()) +
              f" [{seconds:.1f} s]", file=sys.stderr, flush=True)

    chips = spec["chips"]
    if seeds:
        t = time.time()
        if chips == 1:
            runs = []
            for seed in seeds:
                runs.append([run_rank(spec, seed, 0.0, False, window=False)])
        else:
            from perfbench.ranks import spawn

            runs = spawn(spec, seeds, 0.0, False, chips, T_PROCESS, 3000.0, window=False)
        for seed, reports in zip(seeds, runs):
            ref = next(r["reference"] for r in reports if "reference" in r)
            _, checks, where = compare.judge([r["program"] for r in reports], ref,
                                             spec["limits"])
            values = {k: c["value"] for k, c in checks.items()}
            record("program", seed, values, where, (time.time() - t) / len(seeds))
    for seed in controls:
        t = time.time()
        ref = planted(spec, seed, dev)
        kinds = [("control", "fp8", None), ("half_batch", "float32", "half_batch")]
        if chips > 1:
            kinds.append(("no_exchange", "float32", "no_exchange"))
        for kind, precision, fault in kinds:
            t = time.time()
            got = planted(spec, seed, dev, precision, fault)
            values, where = compare.numbers(got, ref)
            record(kind, seed, values, where, time.time() - t)
    text = json.dumps(out, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration, traffic mix and limits by the names in
``BENCHMARK.json``, sets up, measures the training step for ``--seconds``
seconds and prints one JSON line last on standard output. With
``--trace 0`` its metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiled stretch of the
window. ``correct`` is the comparison of the first training steps with the
plain reference; each number compared is printed beside its limit, last on
standard error and last in the result line.

It needs as many CUDA cards as the cell asks for and exits with another code
than 0, printing no result, without them. Kernel builds and caches stay
inside the checkout (``build/``).
"""

from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# The port builds its CUDA sources into build/kernels of the checkout; its
# Triton kernel's cache goes beside them, at a fixed path, before anything
# imports triton.
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
# Neither the run nor anything it loads may use JAX.
os.environ["USE_FLAX"] = "0"

# Every run, traced or not, ends within this many seconds after its start.
RUN_LIMIT_S = 330.0


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
        return "; ".join(line.strip() for line in out.splitlines() if line.strip())
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from perfbench import compare, manifest
    from perfbench.harness import forbidden_modules, run_rank, summarize

    spec = manifest.cell(args.workload)
    chips = spec["chips"]
    if spec["traffic"]["ranks"] != chips:
        print(f"the mix has {spec['traffic']['ranks']} ranks, the cell {chips} chips",
              file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has {count}",
              file=sys.stderr)
        return 2

    traced = bool(args.trace)
    if chips == 1:
        reports = [run_rank(spec, args.seed, args.seconds, traced, t_process=T_PROCESS)]
    else:
        from perfbench.ranks import spawn

        reports = spawn(spec, [args.seed], args.seconds, traced, chips, T_PROCESS,
                        RUN_LIMIT_S - (time.time() - T_PROCESS))[0]
    ref = next(r["reference"] for r in reports if "reference" in r)
    correct, checks, where = compare.judge([r["program"] for r in reports], ref,
                                           spec["limits"])
    result = {"correct": correct, **summarize(spec, reports, traced)}
    card = _card_line()
    result["card"] = card
    result["checks"] = checks

    found = sorted(set(forbidden_modules()).union(*(r["forbidden"] for r in reports)))
    if found:
        print(f"the run loaded {found}: no module of JAX or the JAX package may load",
              file=sys.stderr)
        return 3
    steps = sum(r.get("steps", 0) for r in reports)
    print(f"card: {card}; ranks {chips}; window steps {steps}; setup "
          f"{max(r['setup_s'] for r in reports):.2f} s; reference "
          f"{max(r.get('reference_s', 0.0) for r in reports):.2f} s; wall "
          f"{time.time() - T_PROCESS:.2f} s", file=sys.stderr)
    for r in reports:
        print(f"rank {r['rank']} set-up phases (s from start): {r['setup_phases']}",
              file=sys.stderr)
        if "trace" in r:
            print(f"rank {r['rank']} device ms a step by class: {r['trace']['class_ms']}, "
                  f"optimizer {r['trace']['optimizer_ms']}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} ({where[name]})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

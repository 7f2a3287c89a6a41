"""Where a cell's traced stretch goes, by the port's own ranges.

    python3 perfbench/phases.py --workload <cell> --seed <n> --seconds <s> \
        [--trace 0|1] [--tracer 0|1]

Runs the cell as ``run.py`` does and prints one JSON line last: the run's
metrics and, with ``--trace 1``, each rank's stretch by program range
(``perfbench/program.py``): device ms a step in all and by kernel class,
host ms a step, the device ms launched inside no range, and the longest idle
gaps named by the innermost range, program or benchmark, the host was in.
``--tracer 1`` installs the port's span ``Tracer`` in every rank for the
whole run, to time what recording spans costs. It does not judge
``correct``; ``run.py`` is the benchmark. This runner goes once
``trace.reduce_profile`` splits a stretch by program range itself.
"""

from __future__ import annotations

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# As run.py: Triton's cache inside the checkout, and no JAX.
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["USE_FLAX"] = "0"


def stretch_phases(prof, steps: int) -> dict:
    """One rank's traced stretch by program range, a step's worth; empty
    where the profile has no program range."""
    from collections import defaultdict

    from perfbench import program, trace

    def ms(us):
        return us / steps / 1e3

    def top(ops: dict, n: int = 8) -> list:
        return [(k[:trace.NAME_CHARS], ms(v)) for k, v in
                sorted(ops.items(), key=lambda kv: -kv[1])[:n]]

    r = program.reduce_events(prof.events())
    if r is None:
        return {}
    reduced = trace.reduce_profile(prof)
    classes: dict[str, dict[str, float]] = {}
    for name, ops in r["ops_us"].items():
        split: dict[str, float] = defaultdict(float)
        for op, us in ops.items():
            split[trace.kernel_class(op)] += ms(us)
        classes[name] = dict(split)
    return {"device_ms": {k: ms(v) for k, v in sorted(r["device_us"].items())},
            "class_ms": classes,
            "top_ops": {k: top(v) for k, v in r["ops_us"].items()},
            "host_ms": {k: ms(sum(v)) for k, v in sorted(r["host_us"].items())},
            "unattributed_ms": ms(r["unattributed_us"]),
            "device_total_ms": ms(r["device_total_us"]),
            "idle_gaps": trace.idle_gaps(reduced["device"], reduced["spans"] + r["ranges"])}


def _with_phases(read_trace):
    def read(spec, prof, stretch_s, feed_s, dispatch_s, steps, window_s, dev):
        out = read_trace(spec, prof, stretch_s, feed_s, dispatch_s, steps, window_s, dev)
        from perfbench.harness import TRACE_STEPS

        out["phases"] = stretch_phases(prof, TRACE_STEPS)
        return out

    read.phases = True
    return read


def phases_step(model, cfg, group):
    """The harness's step, after hooking this rank's trace reading."""
    from perfbench import harness

    if not getattr(harness._read_trace, "phases", False):
        harness._read_trace = _with_phases(harness._read_trace)
    return harness.make_step(model, cfg, group)


def tracer_phases_step(model, cfg, group):
    """:func:`phases_step`, with the port's span ``Tracer`` installed."""
    from distkeras_tpu_torch.telemetry.spans import enable_tracing

    enable_tracing()
    return phases_step(model, cfg, group)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=1)
    parser.add_argument("--tracer", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from perfbench import manifest
    from perfbench.harness import run_rank, summarize

    spec = manifest.cell(args.workload)
    factory = tracer_phases_step if args.tracer else phases_step
    traced = bool(args.trace)
    if spec["chips"] == 1:
        reports = [run_rank(spec, args.seed, args.seconds, traced, t_process=T_PROCESS,
                            step_factory=factory)]
    else:
        from perfbench.ranks import spawn

        reports = spawn(spec, [args.seed], args.seconds, traced, spec["chips"], T_PROCESS,
                        600.0, step_factory=factory)[0]
    result = {"workload": args.workload, "seed": args.seed, "trace": args.trace,
              "tracer": args.tracer, **summarize(spec, reports, traced)}
    if traced:
        result["phases"] = [r["trace"].get("phases") for r in reports]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Ranks of a cell on several cards: one process a card, spawned, joined in
one process group over a TCP port on this host.

Each rank runs :func:`perfbench.harness.run_rank` and sends its report back
through a queue; a rank that raises sends its traceback instead. Every rank
is waited for, and one that does not end in time is killed.
"""

from __future__ import annotations

import multiprocessing
import queue
import socket
import time
import traceback

from perfbench.harness import make_step, run_rank


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(out, spec, seeds, seconds, traced, rank, world, init_method, backend, device,
                t_process, step_factory, window):
    import torch

    try:
        report = {"rank": rank, "runs": [
            run_rank(spec, seed, seconds, traced, rank, world, device, t_process, init_method,
                     backend, step_factory, window) for seed in seeds]}
    except BaseException:
        report = {"rank": rank, "error": traceback.format_exc()}
    out.put(report)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def spawn(spec: dict, seeds: list[int], seconds: float, traced: bool, world: int,
          t_process: float, limit_s: float, device: str = "cuda", backend: str = "nccl",
          step_factory=make_step, window: bool = True) -> list[list[dict]]:
    """Every rank's report of a run on ``world`` ranks for each of
    ``seeds`` in turn, by seed; raises ``RuntimeError`` with a rank's
    traceback where one failed, or where ranks did not report within
    ``limit_s`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_entry, name=f"rank-{r}", args=(
        out, spec, seeds, seconds, traced, r, world, init_method, backend, device, t_process,
        step_factory, window)) for r in range(world)]
    for p in procs:
        p.start()
    reports: list[dict] = []
    deadline = time.monotonic() + limit_s
    try:
        while len(reports) < world and time.monotonic() < deadline:
            try:
                reports.append(out.get(timeout=1.0))
                if "error" in reports[-1]:
                    break
            except queue.Empty:
                # A rank that died without a report leaves the others
                # waiting in a collective: stop waiting for them.
                if any(p.exitcode not in (None, 0) for p in procs) and out.empty():
                    break
    finally:
        failed = any("error" in r for r in reports)
        for p in procs:
            p.join(0.0 if failed else max(0.0, min(60.0, deadline - time.monotonic())))
            if p.is_alive():
                p.kill()
                p.join()
    errors = [r["error"] for r in reports if "error" in r]
    if errors:
        raise RuntimeError("a rank failed:\n" + errors[0])
    if len(reports) < world:
        codes = [p.exitcode for p in procs]
        raise RuntimeError(f"{len(reports)} of {world} ranks reported (exit codes {codes})")
    return [[r["runs"][i] for r in reports] for i in range(len(seeds))]

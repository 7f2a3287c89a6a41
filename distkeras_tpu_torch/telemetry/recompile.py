"""Recompile auditor: make "compiled once" a runtime invariant.

Port of the reference's ``distkeras_tpu/telemetry/recompile.py``. The
reference counts the executables a ``jax.jit`` callable compiles. Eager
torch compiles nothing, so here a "compile" is a new **abstract
signature**: the dtype and shape of every tensor a call passes (and the
value of every other leaf), over nested dicts, lists and tuples. One
signature per audited callable is the eager form of "one compiled
executable": a callable that keeps seeing the same shapes would run one
program under a CUDA graph or ``torch.compile``, and a drifted shape or
dtype would make it build another.

- :meth:`RecompileAuditor.wrap` wraps a callable; each new signature is
  recorded with its call index;
- :meth:`RecompileAuditor.arm` - after warmup - turns any FURTHER new
  signature of the named (or all) wrapped callables into a loud
  :class:`RecompileError` at the call that brought it, with the
  offending signature in the message.

``wrap(..., signature=fn)`` signs ``fn(args, kwargs)`` instead of the
call's own arguments: a trainer signs its step by the state's tensors and
the batch, leaving out the Python step counter the port's ``TrainState``
carries where the reference's carries a device scalar.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable

from distkeras_tpu_torch.utils.pytree import _flatten_with_paths

__all__ = [
    "RecompileAuditor",
    "RecompileError",
    "CompileEvent",
    "abstract_signature",
]


class RecompileError(RuntimeError):
    """An armed callable compiled again after warmup."""


def _leaf_sig(x: Any) -> str:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        try:
            # torch names dtypes "torch.float32"; the reference prints "float32".
            name = str(dtype).removeprefix("torch.")
            return f"{name}[{','.join(str(d) for d in shape)}]"
        except Exception:
            return f"{type(x).__name__}"
    # Non-array leaves retrace on VALUE (they are static or hashed into
    # weak-typed constants) — include the value, not just the type.
    return f"{type(x).__name__}={x!r}"


def abstract_signature(args: tuple, kwargs: dict) -> str:
    """Compact dtype[shape] signature of a call's abstract values — the
    identity jit traces on (up to weak types / static args). The tree is
    flattened as ``jax.tree.flatten`` flattens it (dict keys sorted; lists
    and tuples in order; ``None`` an empty node), and its structure is the
    leaves' key paths."""
    pairs = list(_flatten_with_paths((args, kwargs)))
    try:
        parts = [_leaf_sig(leaf) for _, leaf in pairs]
    except Exception:
        return "<unavailable>"
    tree = ",".join("/".join(path) for path, _ in pairs)
    return f"({', '.join(parts)}) tree={tree}"


@dataclasses.dataclass
class CompileEvent:
    """One observed compile: which callable, which call, what shapes."""

    name: str
    call_index: int
    signature: str
    armed: bool


class _AuditedFn:
    """Callable wrapper counting the abstract signatures of one callable.

    Transparent: ``__getattr__`` delegates to the wrapped callable."""

    def __init__(self, fn: Callable, name: str, auditor: "RecompileAuditor",
                 signature: Callable | None = None):
        self._fn = fn
        self.name = name
        self._auditor = auditor
        self._signature = signature
        self._lock = threading.Lock()
        self.calls = 0
        self.compiles = 0
        self.armed = False
        self._seen_sigs: set[str] = set()

    def __call__(self, *args, **kwargs):
        with self._lock:
            self.calls += 1
        if self._signature is None:
            sig = abstract_signature(args, kwargs)
        else:
            sig = abstract_signature((self._signature(args, kwargs),), {})
        with self._lock:
            fresh = sig not in self._seen_sigs
            self._seen_sigs.add(sig)
        if fresh:
            # Before the call, as a compile happens before the run: an armed
            # callable raises without running the new shape.
            self._auditor._on_compile(self, sig)
        return self._fn(*args, **kwargs)

    def __getattr__(self, name: str) -> Any:
        return getattr(self._fn, name)


class RecompileAuditor:
    """Audits a set of wrapped jitted callables.

    ``registry``: optional :class:`~distkeras_tpu_torch.telemetry.registry.
    MetricsRegistry`; every observed compile increments
    ``recompile_auditor_compiles_total{fn=...}`` so the scrape endpoint
    shows compile counts live.
    """

    def __init__(self, registry=None):
        self._lock = threading.Lock()
        self._fns: dict[str, _AuditedFn] = {}
        self.events: list[CompileEvent] = []
        self._registry = registry

    def wrap(self, fn: Callable, name: str,
             signature: Callable | None = None) -> _AuditedFn:
        """Wrap ``fn`` under ``name``; returns the transparent audited
        callable to use in its place. ``signature(args, kwargs)``, when
        given, is the tree a call is signed by."""
        wrapped = _AuditedFn(fn, name, self, signature)
        with self._lock:
            if name in self._fns:
                raise ValueError(f"auditor already wraps a fn named {name!r}")
            self._fns[name] = wrapped
        return wrapped

    def _on_compile(self, fn: _AuditedFn, signature: str, n: int = 1) -> None:
        with fn._lock:  # compiles/calls share the wrapper's lock
            fn.compiles += n
            ev = CompileEvent(fn.name, fn.calls, signature, fn.armed)
        with self._lock:
            self.events.append(ev)
        if self._registry is not None:
            self._registry.counter(
                "recompile_auditor_compiles_total",
                help="compiles observed by the recompile auditor",
                fn=fn.name,
            ).inc(n)
        if fn.armed:
            raise RecompileError(
                f"{fn.name!r} recompiled after warmup (compile "
                f"#{fn.compiles}, call #{fn.calls}) — triggering abstract "
                f"signature: {signature}"
            )

    def arm(self, *names: str) -> None:
        """Fail loudly on any further compile of the named callables (all
        wrapped callables when no names given). Call after warmup — e.g.
        after the first decode iteration, or after the first train step."""
        with self._lock:
            targets = names or tuple(self._fns)
            for n in targets:
                if n not in self._fns:
                    raise KeyError(f"auditor wraps no fn named {n!r}")
                self._fns[n].armed = True

    def disarm(self, *names: str) -> None:
        with self._lock:
            for n in (names or tuple(self._fns)):
                self._fns[n].armed = False

    def compiles(self, name: str) -> int:
        return self._fns[name].compiles

    def total_compiles(self) -> int:
        return sum(f.compiles for f in self._fns.values())

    def report(self) -> dict:
        """Per-callable compile/call counts with triggering signatures —
        JSON-able, printed by ``run.py --audit-recompiles`` at exit."""
        with self._lock:
            events = list(self.events)
            fns = dict(self._fns)
        out = {}
        for name, fn in fns.items():
            out[name] = {
                "calls": fn.calls,
                "compiles": fn.compiles,
                "armed": fn.armed,
                "signatures": [e.signature for e in events if e.name == name],
            }
        return out

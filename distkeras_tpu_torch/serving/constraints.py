"""Token-level automata for constrained (structured) decoding.

A constraint rides a request as a plain JSON table — a deterministic
finite automaton over TOKEN IDS — and is advanced entirely host-side by
the engine: after every emitted token the slot's automaton state steps,
the allowed-token mask for the new state is written into the engine's
host mask buffer, and the device copy refreshes under the same
dirty-flag upload discipline the paged block tables use. The decode
step takes the mask as a plain ``[slots, vocab]`` operand — its shape
never changes, so the one-signature invariant survives with constraints
on (the armed ``RecompileAuditor`` proves it).

Copied from the reference's ``distkeras_tpu/serving/constraints.py`` (it
imports nothing but numpy).

Why a token DFA and not a regex/grammar engine in-process: the table is
the COMPILED form. A caller with a regex or JSON grammar lowers it to
token transitions offline (where the tokenizer lives); the serving tier
only ever walks an integer table, which keeps the per-token host cost at
one dict lookup and the wire format at a few hundred bytes.

Wire form (the ``constraint`` field of a request spec)::

    {"start": 0,
     "edges": [[state, token, next_state], ...]}

States are dense ints ``0..n``. A state with NO outgoing edges is
terminal: reaching it force-finishes the request (the automaton has
nothing left to allow). Malformed tables raise :class:`ValueError` at
admission — a typed ``bad_request``, never a mid-stream engine error.
"""

from __future__ import annotations

import numpy as np

__all__ = ["TokenDFA", "MASK_NEG"]

# Additive logit penalty for forbidden tokens. Finite (not -inf) so a
# fully-masked row — which the engine prevents by force-finishing
# terminal states, but defense in depth — still produces SOME argmax
# instead of NaNs through softmax-style paths.
MASK_NEG = np.float32(-1e9)

# Guardrails on wire input: a constraint table is a few transitions to
# a few thousand, never millions — beyond this it is garbage or abuse.
_MAX_EDGES = 100_000
_MAX_STATES = 65_536


class TokenDFA:
    """A deterministic token automaton with per-state mask rows.

    ``edges`` maps ``state -> {token_id -> next_state}``. Mask rows
    (float32 ``[vocab]``: 0 where allowed, :data:`MASK_NEG` where
    forbidden) are built lazily per state and cached — the hot loop is
    one dict hit per emitted token plus, on a state change, one cached
    row copy into the engine's host mask buffer.
    """

    def __init__(self, start: int, edges: dict[int, dict[int, int]]):
        self.start = int(start)
        self.edges = edges
        self._mask_cache: dict[int, np.ndarray] = {}
        self._vocab: int | None = None

    @classmethod
    def from_spec(cls, spec: object) -> "TokenDFA":
        """Validate and compile a wire-form constraint table.

        Raises :class:`ValueError` on anything malformed — the engine
        maps that to the typed ``bad_request`` at admission.
        """
        if not isinstance(spec, dict):
            raise ValueError(
                f"constraint must be an object with 'start' and 'edges', "
                f"got {type(spec).__name__}")
        raw_edges = spec.get("edges")
        if not isinstance(raw_edges, (list, tuple)) or not raw_edges:
            raise ValueError("constraint needs a non-empty 'edges' list "
                             "of [state, token, next_state] triples")
        if len(raw_edges) > _MAX_EDGES:
            raise ValueError(
                f"constraint has {len(raw_edges)} edges "
                f"(limit {_MAX_EDGES})")
        edges: dict[int, dict[int, int]] = {}
        for i, e in enumerate(raw_edges):
            if (not isinstance(e, (list, tuple)) or len(e) != 3):
                raise ValueError(
                    f"constraint edge {i} must be [state, token, "
                    f"next_state], got {e!r}")
            try:
                s, tok, nxt = int(e[0]), int(e[1]), int(e[2])
            except (TypeError, ValueError):
                raise ValueError(
                    f"constraint edge {i} has non-integer fields: "
                    f"{e!r}") from None
            if s < 0 or nxt < 0 or tok < 0:
                raise ValueError(
                    f"constraint edge {i} has negative fields: {e!r}")
            if s >= _MAX_STATES or nxt >= _MAX_STATES:
                raise ValueError(
                    f"constraint edge {i} names state past "
                    f"{_MAX_STATES}: {e!r}")
            out = edges.setdefault(s, {})
            prev = out.get(tok)
            if prev is not None and prev != nxt:
                raise ValueError(
                    f"constraint is nondeterministic: state {s} has two "
                    f"edges for token {tok} ({prev} and {nxt})")
            out[tok] = nxt
        try:
            start = int(spec.get("start", 0))
        except (TypeError, ValueError):
            raise ValueError(
                f"bad constraint start {spec.get('start')!r}") from None
        if start not in edges:
            raise ValueError(
                f"constraint start state {start} has no outgoing edges "
                f"(the automaton would finish before the first token)")
        return cls(start, edges)

    # -- walking ------------------------------------------------------------
    def step(self, state: int, token: int) -> int | None:
        """The state after emitting ``token``, or None when the automaton
        has no such edge (the token was forbidden)."""
        out = self.edges.get(state)
        if out is None:
            return None
        return out.get(int(token))

    def is_terminal(self, state: int) -> bool:
        """True when ``state`` allows nothing — the engine force-finishes
        the request here (streaming on would emit a forbidden token)."""
        return not self.edges.get(state)

    def valid_prefix(self, state: int, tokens) -> int:
        """Length of the longest prefix of ``tokens`` the automaton can
        walk from ``state`` — the speculative-verify clamp: committed
        drafts past it are rejected before they reach the client."""
        n = 0
        for tok in tokens:
            nxt = self.step(state, tok)
            if nxt is None:
                break
            state = nxt
            n += 1
            if self.is_terminal(state):
                break
        return n

    # -- masking ------------------------------------------------------------
    def mask_row(self, state: int, vocab: int) -> np.ndarray:
        """The additive logit mask for ``state``: float32 ``[vocab]``,
        0 at allowed token ids, :data:`MASK_NEG` elsewhere. Cached per
        state (and invalidated if asked for a different vocab — one DFA
        instance serves one engine)."""
        if self._vocab != vocab:
            self._mask_cache.clear()
            self._vocab = vocab
        row = self._mask_cache.get(state)
        if row is None:
            row = np.full((vocab,), MASK_NEG, np.float32)
            for tok in self.edges.get(state, ()):
                if 0 <= tok < vocab:
                    row[tok] = 0.0
            self._mask_cache[state] = row
        return row

    def max_token(self) -> int:
        """Largest token id named by any edge — admission validates it
        against the engine's vocab so an out-of-vocab table is a typed
        reject, not a silently-unreachable edge."""
        return max((t for out in self.edges.values() for t in out),
                   default=0)

"""pw.stdlib.ml.hmm — hidden-markov-model state tracking as a reducer: the
port's own copy of ``pathway_tpu/stdlib/ml/hmm.py`` (reference:
python/pathway/stdlib/ml/hmm.py — builds a stateful reducer that tracks
the most likely hidden state as observations stream in). The accumulator
keeps a log-probability beam over hidden states and Viterbi-advances it
per observation on the host, in plain ``math``; use inside
``groupby(...).reduce(state=hmm_reducer(obs_column))``. Nothing is left
out.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable

from pathway_tpu_torch.reducers import stateful_single


@dataclass
class DenseHMM:
    """A discrete HMM: states, initial/transition log-space probabilities
    and an emission probability function p(obs | state)."""

    states: list[Hashable]
    initial: dict[Hashable, float] = field(default_factory=dict)
    transitions: dict[tuple[Hashable, Hashable], float] = field(
        default_factory=dict
    )
    emission: Callable[[Hashable, Any], float] = lambda s, o: 1.0

    def log_initial(self, s: Hashable) -> float:
        p = self.initial.get(s, 1.0 / len(self.states))
        return math.log(p) if p > 0 else -math.inf

    def log_transition(self, s0: Hashable, s1: Hashable) -> float:
        p = self.transitions.get((s0, s1), 0.0)
        return math.log(p) if p > 0 else -math.inf

    def log_emission(self, s: Hashable, obs: Any) -> float:
        p = self.emission(s, obs)
        return math.log(p) if p > 0 else -math.inf


def create_hmm_reducer(hmm: DenseHMM, beam_size: int | None = None):
    """Returns a reducer: column of observations -> beam over hidden states
    (Viterbi filtering). `stateful_single` calls the combiner once per row
    with the single observation value."""

    def combine(state, obs):
        # state: tuple of (hidden_state, logp) pairs or None
        beam = dict(state) if state else None
        if beam is None:
            beam = {
                s: hmm.log_initial(s) + hmm.log_emission(s, obs)
                for s in hmm.states
            }
        else:
            new_beam: dict[Hashable, float] = {}
            for s1 in hmm.states:
                best = -math.inf
                for s0, lp in beam.items():
                    cand = lp + hmm.log_transition(s0, s1)
                    if cand > best:
                        best = cand
                e = hmm.log_emission(s1, obs)
                if best + e > -math.inf:
                    new_beam[s1] = best + e
            beam = new_beam or beam
        if beam_size is not None and len(beam) > beam_size:
            beam = dict(
                sorted(beam.items(), key=lambda kv: -kv[1])[:beam_size]
            )
        return tuple(sorted(beam.items(), key=lambda kv: -kv[1]))

    return stateful_single(combine)


def most_likely_state(beam: tuple) -> Any:
    """Extract the argmax state from a beam produced by the hmm reducer
    (use in a select after the reduce)."""
    return beam[0][0] if beam else None

"""The n-gram (prompt-lookup) drafter for speculative decoding.

The port's copy of ``repro.serving.draft.NGramDrafter``, plain Python:
no draft model and no device work.  It matches the longest recent
suffix of a slot's committed token history against earlier occurrences
and proposes the continuation that followed last time.  On repetitive
streams (code, structured text, copy-heavy prompts) most drafts are
accepted; on incompressible ones the verify step still commits one
token a step, as ``spec_k=0`` does.

The drafter is pure host state derived from the committed stream, so a
slot proposes the same drafts whatever shares the batch — which the
engine's greedy spec/vanilla token identity needs.  The host must see
step t's committed tokens before it drafts step t+1.
"""
from __future__ import annotations

from typing import List, Sequence

#: the n-gram sizes matched, longest first
_MAX_N, _MIN_N = 3, 1


class NGramDrafter:
    """Prompt-lookup drafter over one slot's committed token history.

    ``propose(k)`` scans for the most recent earlier occurrence of the
    longest history suffix (n-gram sizes ``_MAX_N`` down to ``_MIN_N``) and
    proposes the k tokens that followed it; when no n-gram matches it
    falls back to repeating the last committed token.
    """

    def __init__(self, prompt: Sequence[int]):
        self.history: List[int] = [int(t) for t in prompt]

    def extend(self, tokens: Sequence[int]):
        """Append newly committed tokens to the lookup history."""
        self.history.extend(int(t) for t in tokens)

    def propose(self, k: int) -> List[int]:
        """k draft tokens continuing the current history (deterministic)."""
        h = self.history
        if not h:
            return [0] * k
        for n in range(min(_MAX_N, len(h) - 1), _MIN_N - 1, -1):
            suffix = h[-n:]
            # most recent earlier occurrence of the suffix
            for i in range(len(h) - n - 1, -1, -1):
                if h[i:i + n] == suffix:
                    cont = h[i + n:i + n + k]
                    if cont:
                        return cont + [h[-1]] * (k - len(cont))
        return [h[-1]] * k

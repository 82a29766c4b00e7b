"""N-gram self-drafter for speculative decoding — host-side by design.

A copy of ``distributed_tensorflow_models_tpu/serving/drafter.py``.
Prompt-lookup drafting (the no-second-model end of the speculative
decoding family): the request's own token history — prompt plus
everything generated so far — is the draft model.  When the last
``n`` tokens have appeared before, the tokens that followed that
earlier occurrence are proposed as the continuation.  Chat and code
traffic is highly repetitive (restated prompts, copied identifiers,
templated boilerplate), so suffix matches are common exactly where
speculation pays; on incompressible traffic the drafter simply finds
no match and proposes nothing, which the engine turns into a plain
burst dispatch (zero drafting overhead on the device).

Host-side and stdlib+numpy only: proposals are DATA fed to the one
decode program (``engine.py``), never captured, so the drafter can use
dicts and Python ints freely without touching the compile-count pin.
The verify rule in the engine — a draft is accepted iff the target's
own sample (with that position's ``key_schedule`` key) equals it —
means a drafter can only ever cost throughput, never change a token:
byte-identity to solo ``generate()`` holds at ANY acceptance rate, so
this module needs to be fast and honest, not correct-by-proof.

Matching is longest-first: orders ``ngram_order`` down to
``min_match`` are tried in turn, and within an order the MOST RECENT
earlier occurrence wins (recency tracks the local phrase distribution
better than the first occurrence).  Tables are per-request and
incremental — O(orders) dict updates per appended token, O(orders)
lookups per proposal — so drafting adds microseconds to a scheduler
iteration whose device dispatch costs milliseconds.
"""

from __future__ import annotations

import numpy as np

# Proposal slots the drafter leaves empty.  Device-side the engine
# clamps these to token 0 before the embedding lookup (the positions
# are inert: acceptance stops at the first pad, so their samples and
# KV writes are discarded/overwritten); host-side -1 can never equal a
# real vocab token, so a padded slot can never be "accepted" even by a
# garbage sample collision.
NO_DRAFT = -1


class NgramDrafter:
    """Per-request suffix-match table over prompt + generated history.

    ``propose`` returns an int32 ``[spec_tokens]`` vector padded with
    :data:`NO_DRAFT`; ``append`` must be called with every token the
    scheduler emits for this request (the same stream the model saw),
    or proposals drift from the true context and acceptance decays —
    never correctness, which the engine's verify rule owns.
    """

    def __init__(self, prompt, *, spec_tokens: int, ngram_order: int = 3,
                 min_match: int = 1):
        if spec_tokens < 1:
            raise ValueError(
                f"spec_tokens must be >= 1, got {spec_tokens}"
            )
        if min_match < 1:
            raise ValueError(
                f"min_match must be >= 1, got {min_match}"
            )
        if ngram_order < min_match:
            raise ValueError(
                f"ngram_order {ngram_order} must be >= min_match "
                f"{min_match}"
            )
        self.spec_tokens = int(spec_tokens)
        self.ngram_order = int(ngram_order)
        self.min_match = int(min_match)
        self._hist: list = []
        # (order, gram) -> end index of its latest occurrence; _prev
        # holds the occurrence before that.  The current suffix is
        # itself the latest occurrence of its own grams, so propose()
        # steps back to _prev when _last points at the suffix.
        self._last: dict = {}
        self._prev: dict = {}
        for tok in np.asarray(prompt).reshape(-1):
            self.append(int(tok))

    def append(self, token: int) -> None:
        """Extend the history by one emitted token and index the grams
        that now end at it."""
        self._hist.append(int(token))
        j = len(self._hist) - 1
        for n in range(self.min_match, self.ngram_order + 1):
            if j + 1 < n:
                break
            key = (n, tuple(self._hist[j + 1 - n: j + 1]))
            if key in self._last:
                self._prev[key] = self._last[key]
            self._last[key] = j

    def propose(self) -> np.ndarray:
        """Up to ``spec_tokens`` continuation tokens for the current
        suffix, :data:`NO_DRAFT`-padded; all-padding when no suffix of
        length >= ``min_match`` has occurred before."""
        out = np.full((self.spec_tokens,), NO_DRAFT, np.int32)
        j = len(self._hist) - 1
        for n in range(self.ngram_order, self.min_match - 1, -1):
            if j + 1 < n:
                continue
            key = (n, tuple(self._hist[j + 1 - n: j + 1]))
            pos = self._last.get(key)
            if pos == j:
                pos = self._prev.get(key)
            if pos is None:
                continue
            # Copy the continuation of the earlier occurrence.  When it
            # runs off the end of history (the match sits close to the
            # suffix — always true for constant runs and short cycles,
            # where the latest previous occurrence is the suffix minus
            # one period), extend periodically: a match at distance p
            # predicts hist[t] == hist[t - p], so fold the read index
            # back by the period instead of truncating the proposal.
            period = j - pos
            idx = pos + 1
            for i in range(self.spec_tokens):
                if idx > j:
                    idx -= period
                out[i] = self._hist[idx]
                idx += 1
            break
        return out

    @property
    def history_len(self) -> int:
        return len(self._hist)

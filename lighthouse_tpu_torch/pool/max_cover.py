"""Greedy maximum-coverage (reference beacon_node/operation_pool/src/
max_cover.rs:11-31): pick k items maximizing covered weight, re-scoring
remaining items against the running cover each round.

The port's copy of lighthouse_tpu/pool/max_cover.py.
"""

from __future__ import annotations


def max_cover(items, covering, weight, limit: int):
    """items: candidates; covering(item) -> {element: weight}; `weight` is
    kept for API parity (scores derive from covering); returns chosen items
    in selection order."""
    remaining = [(item, dict(covering(item))) for item in items]
    chosen = []
    covered: set = set()
    for _ in range(limit):
        best = None
        best_score = 0
        for i, (item, cover) in enumerate(remaining):
            score = sum(w for e, w in cover.items() if e not in covered)
            if score > best_score:
                best = i
                best_score = score
        if best is None:
            break
        item, cover = remaining.pop(best)
        chosen.append(item)
        covered.update(cover.keys())
    return chosen

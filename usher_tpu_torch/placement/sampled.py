"""Batched sample placement: the usher-sampled capability (counterpart of
usher_tpu/placement/sampled.py).

The reference (src/usher-sampled/place_sample.cpp) distributes samples over
MPI followers that search slightly-stale tree replicas; the leader applies
proposals serially and retries any whose target region changed
(place_sample.cpp:479-520).  Here the same discipline becomes: score a whole
batch against a frozen device snapshot in ONE scoring call (the fused B1
kernel on CUDA, PlacementEngine.score_samples), then apply
the proposals in order, re-scoring only samples whose winning region was
touched by an earlier apply in the same batch (stale retry).  Path states of
untouched nodes are invariant under placement surgery, so non-stale
proposals remain exactly optimal for the tree-at-apply-time except for the
(tolerated, as in the reference) possibility that a better placement exists
among the handful of nodes created earlier in the batch.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

from ..core.tree import MissingSample
from .driver import PlacementEngine, SampleResult
from .mapper import score_placement


def _err(*a):
    print(*a, file=sys.stderr)


@dataclass
class BatchPlacementStats:
    placed: int = 0
    retried: int = 0
    ignored: int = 0
    parsimony_increase: int = 0


def place_batch(engine: PlacementEngine, samples: list[MissingSample],
                batch_size: int = 256, max_uncertainty: int = 1_000_000,
                max_parsimony: int = 1_000_000,
                collect_clades: bool = True,
                on_placed=None) -> BatchPlacementStats:
    """Place `samples` into engine's tree in batches.

    on_placed(sample, result, detail) is called after each successful apply
    (for stats files / clade assignment handled by the caller).
    """
    T = engine.flat.tree
    stats = BatchPlacementStats()

    for start in range(0, len(samples), batch_size):
        chunk = [s for s in samples[start:start + batch_size]
                 if T.get_node(s.name) is None]
        if not chunk:
            continue
        results = engine.score_samples([s.mutations for s in chunk])
        # nodes touched by surgery in this batch (identifier strings)
        touched: set[str] = set()
        for s, res in zip(chunk, results):
            best = res.best_node
            stale = (best.identifier not in T._all_nodes
                     or T.get_node(best.identifier) is not best
                     or best.identifier in touched
                     or (best.parent is not None
                         and best.parent.identifier in touched))
            if stale:
                res = engine.score_samples([s.mutations])[0]
                best = res.best_node
                stats.retried += 1

            if (res.num_best > max_uncertainty
                    or res.best_score > max_parsimony):
                stats.ignored += 1
                if on_placed is not None:
                    on_placed(s, res, None)
                continue

            detail = score_placement(best, s.mutations)
            if detail.set_difference != res.best_score:
                # region was touched in a way our conservative rule missed;
                # exact retry
                res = engine.score_samples([s.mutations])[0]
                best = res.best_node
                detail = score_placement(best, s.mutations)
                stats.retried += 1

            parent_before = best.parent
            engine.apply_placement(s.name, res, detail.excess)
            stats.placed += 1
            stats.parsimony_increase += detail.set_difference

            touched.add(best.identifier)
            if parent_before is not None:
                touched.add(parent_before.identifier)
            if best.parent is not None and best.parent is not parent_before:
                touched.add(best.parent.identifier)  # new split internal
            touched.add(s.name)

            if on_placed is not None:
                on_placed(s, res, detail)
    return stats

"""Plain batch placement of usher-sampled onto the generated MAT.

The semantics are those of the port's `placement/sampled.py::place_batch`
as usher-sampled-server calls it (`cli/usher_socket_server_cli.py::
handle_placement`, :180-263: batches of 256, `-e` and `-E` at 1,000,000),
at commit de2a1c187825; nothing of the port is imported.  They differ from
UShER's sequential placement (`placer.py`) on purpose, and follow
usher-sampled's MPI leader, which applies proposals made on a stale replica
(src/usher-sampled/place_sample.cpp:479-520):

- a sample already placed is skipped (sampled.py:54-55; the VCF reader
  keeps only samples the loaded tree lacks);
- every sample of a batch is scored against the tree as the batch began
  (:58), the winner being the tied node with the most leaves, then the
  latest breadth-first rank (`placer.Placer.score`, as
  `placement/driver.py::PlacementEngine.score_samples` :205-208 picks it);
- a sample is stale when its winner, or the winner's current parent, is in
  the batch's touched set (:63-67; a node keeps its id here, so the
  winner is always still that node), and a stale sample is scored again,
  exactly, on the current tree (:68-71);
- `-e` and `-E` (:73-78) never bind: no tie set or score reaches 1,000,000
  on a tree of fewer nodes and sites;
- the score at the winner on the current tree (`score_placement`, :80;
  here `placer.explicit_score`) gives the parsimony score
  (`set_difference`) and the mutations the apply moves (`excess`); where
  it differs from the batch's score, the sample is scored again exactly
  (:81-87);
- the sample is applied at the winner with that score's mutations
  (:89-90; `placer.Placer.apply`), and the touched set gains the winner,
  its parent before the apply, its new parent where the apply split its
  branch, and the sample (:94-99);
- placement_stats.tsv has one line a sample: its name, the set_difference
  and the num_best of the result it was applied with
  (usher_socket_server_cli.py:224); mutation-paths.txt and final-tree.nh
  are written from the final tree (:233-246: `-u` not given).
"""

from __future__ import annotations

import numpy as np

from .placer import Placer, explicit_score


class SampledBatchPlacer(Placer):
    """A request's batch placement onto a fresh copy of the base tree."""

    def run(self, job: dict, batch_size: int = 256):
        """Place the job's samples batch by batch: (placement_stats.tsv
        lines, mutation-paths.txt lines, final-tree.nh text)."""
        self.placed = {}
        names, ptr = job["names"], job["ptr"]
        col, nuc = job["col"], job["nuc"]
        B = len(names)
        stats = []
        for b0 in range(0, B, batch_size):
            b1 = min(B, b0 + batch_size)
            rows = [i for i in range(b0, b1) if names[i] not in self.placed]
            if not rows:
                continue
            ucols = np.unique(col[int(ptr[b0]):int(ptr[b1])])
            S = self.base.paint(ucols)
            args = []
            for i in rows:
                c = col[ptr[i]:ptr[i + 1]].astype(np.int64)
                x = nuc[ptr[i]:ptr[i + 1]]
                args.append((dict(zip(c.tolist(), x.tolist())),
                             np.searchsorted(ucols, c), c, x))
            snap = [self.score(*a, S) for a in args]
            touched: set = set()
            for i, a, (best, nb, win, r) in zip(rows, args, snap):
                if win in touched or (win != 0 and
                                      self.cur_parent(win) in touched):
                    best, nb, win, r = self.score(*a, S)
                else:
                    r = explicit_score(self.base, a[0],
                                       self.state(self.cur_parent(win)),
                                       self.branch(win), self.is_leaf(win))
                if r[0] != best:
                    best, nb, win, r = self.score(*a, S)
                parent_before = self.cur_parent(win) if win != 0 else None
                self.apply(names[i], win, r)
                stats.append(f"{names[i]}\t{r[0]}\t{nb}\t\n")
                touched.update((win, self.placed[names[i]]))
                if parent_before is not None:
                    touched.update((parent_before, self.cur_parent(win)))
            del S
        paths = [self.mutation_path(n) for n in names]
        return stats, paths, self.newick()

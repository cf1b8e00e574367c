"""Milliseconds a request spends writing final-tree.nh and
mutation-paths.txt (`io/newick.py::write_newick` and
`placement/driver.py::write_mutation_paths`, called from the daemon's
`handle_placement`), timed from outside."""

KEYS = ("write_newick", "mutation_paths")


def read(run):
    rec = run.rec
    if not rec.units or not any(k in rec.spans for k in KEYS):
        return None
    return sum(rec.seconds(k) for k in KEYS) * 1e3 / len(rec.units)

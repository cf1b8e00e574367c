"""Milliseconds a job spends writing the final tree and the mutation paths
(`DirectPlacer.write_newick`, `_mutation_path`), timed from outside."""


def read(run):
    rec = run.rec
    if not rec.units or "write_newick" not in rec.spans:
        return None
    return ((rec.seconds("write_newick") + rec.seconds("mutation_path"))
            * 1e3 / len(rec.units))

"""Seconds of set-up (the warm-up unit included) spent in the loaders: pb
parse, VCF read, BigMAT build and ranks (direct), or the MatStore's loads
and the VCF read (server)."""

KEYS = ("load_pb", "read_vcf", "bigmat_build", "ranks")


def read(run):
    spans = run.rec.setup_spans
    if not any(k in spans for k in KEYS):
        return None
    return sum(b - a for k in KEYS for a, b in spans.get(k, []))

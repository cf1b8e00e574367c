"""Milliseconds a job of the window spends in the loaders: the pb parse
(`io/pb_arrays.py` with the native scanner), the VCF read, the BigMAT build
and its ranks (`core/bigmat.py`), timed from outside."""

KEYS = ("load_pb", "read_vcf", "bigmat_build", "ranks")


def read(run):
    rec = run.rec
    if not rec.units or "bigmat_build" not in rec.spans:
        return None
    return sum(rec.seconds(k) for k in KEYS) * 1e3 / len(rec.units)

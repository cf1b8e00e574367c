"""`usher --pb-direct` jobs in a closed loop: each job places its VCF's
samples onto the configuration's pb.

A job is what `placement/direct.py::run_usher_direct` does: a
`DirectPlacer` over the pb and the job's VCF (pb parse, VCF read, BigMAT
build and ranks), then `place_all` with usher's default outputs (final
tree, mutation paths, placement stats), no `-s`, batches of the mix's
`batch_size`.  Every job starts from the same tree, as a day's run starts
from the day's public tree.  The placer is built per job because it takes
its samples when it is built, and a second `place_all` would place onto
the tree the first one grew.
"""

from __future__ import annotations


class Driver:
    # the spies that the end-to-end readers need (sample_p95_ms)
    E2E_KEYS = ("scoring_begin", "apply")

    def __init__(self, inputs: dict, traffic: dict):
        self.inputs = inputs
        self.traffic = traffic
        self._batch_t0 = None

    def targets(self):
        """(target, key) of every call the harness times."""
        d = "usher_tpu_torch.placement.direct:"
        bm = "usher_tpu_torch.core.bigmat:BigMAT."
        return [(d + "load_mat_arrays", "load_pb"),
                (d + "read_vcf_sites", "read_vcf"),
                (bm + "__init__", "bigmat_build"),
                (bm + "_recompute_ranks", "ranks"),
                (d + "DirectPlacer.place_all", "place_all"),
                (bm + "place_arrays_begin", "scoring_begin"),
                (bm + "_flush", "flush"),
                (bm + "place_arrays_finish", "scoring_finish"),
                (d + "_BatchState.resolve", "resolve"),
                (d + "DirectPlacer.apply_placement", "apply"),
                (d + "DirectPlacer.write_newick", "write_newick"),
                (d + "DirectPlacer._mutation_path", "mutation_path")]

    def hooks(self, rec):
        """A sample's latency runs from its batch's scoring call to the
        return of its own apply_placement."""

        def begin(phase, t, *_):
            if phase == "enter":
                self._batch_t0 = t

        def apply(phase, t, *_):
            if phase == "exit" and rec.live and self._batch_t0 is not None:
                rec.latency_s.append(t - self._batch_t0)
        return {"scoring_begin": begin, "apply": apply}

    def setup(self) -> None:
        from usher_tpu_torch.utils.device import apply_platform_env
        apply_platform_env()

    def run_unit(self, k: int, outdir: str) -> int:
        from usher_tpu_torch.placement.direct import (DirectOptions,
                                                      DirectPlacer)
        unit = self.inputs["units"][k]
        placer = DirectPlacer(self.inputs["pb"], unit["vcf"])
        placer.place_all(DirectOptions(
            outdir=outdir, batch_size=self.traffic["batch_size"]))
        return len(unit["names"])

    def release(self) -> None:
        import gc
        gc.collect()

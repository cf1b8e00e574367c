"""usher_server placement requests in a closed loop, one client.

The server is `cli/usher_server_cli.py`: a `MatStore` that pre-loads the
configuration's pb from a MAT list in set-up, and `run_request` for each
request's argument line (`-i <pb> -v <request VCF> -d <outdir>`: the Tree
path, batches of 64, no `-s`).  A request consumes the tree, so before each
request the loop reloads a consumed tree (`refresh_consumed`), as the daemon
does at the top of its loop; the reload is part of the request's time.
"""

from __future__ import annotations

import os


class Driver:
    # no end-to-end reader of this driver reads a spy
    E2E_KEYS = ()

    def __init__(self, inputs: dict, traffic: dict):
        self.inputs = inputs
        self.traffic = traffic
        self.store = None
        self.workdir = None

    def targets(self):
        """(target, key) of every call the harness times."""
        srv = "usher_tpu_torch.cli.usher_server_cli:"
        drv = "usher_tpu_torch.placement.driver:"
        ps = "usher_tpu_torch.ops.placement_sparse:"
        return [(srv + "MatStore._load", "load_pb"),
                (srv + "read_vcf", "read_vcf"),
                (srv + "run_usher", "run_usher"),
                (drv + "PlacementEngine.__init__", "flat_build"),
                (drv + "PlacementEngine.score_samples", "score_batch"),
                (drv + "PlacementEngine.apply_placement", "apply"),
                (drv + "_write_outputs", "write_outputs"),
                (ps + "parent_states", "gather"),
                (ps + "score_sparse_stp_T", "b1")]

    def hooks(self, rec):
        """Record each B1 call's shapes (st [N, P], slots [B, K])."""
        def b1(phase, t, args, kwargs, out):
            if phase == "enter" and rec.live:
                st, pos = args[0], args[3]
                rec.calls.setdefault("b1", []).append(
                    (tuple(st.shape), tuple(pos.shape)))
        return {"b1": b1}

    def setup(self) -> None:
        from usher_tpu_torch.cli.usher_server_cli import MatStore
        from usher_tpu_torch.utils.device import apply_platform_env
        apply_platform_env()
        listing = os.path.join(self.workdir, "mats.txt")
        with open(listing, "w") as f:
            f.write(self.inputs["pb"] + "\n")
        self.store = MatStore(listing)
        if not self.store.load_list():
            raise RuntimeError("the MAT list did not load")

    def run_unit(self, k: int, outdir: str) -> int:
        from usher_tpu_torch.cli.usher_server_cli import run_request
        unit = self.inputs["units"][k]
        self.store.refresh_consumed()
        rc = run_request(["-i", self.inputs["pb"], "-v", unit["vcf"],
                          "-d", outdir], self.store)
        if rc != 0:
            raise RuntimeError(f"request {k} returned {rc}")
        return len(unit["names"])

    def release(self) -> None:
        import gc
        self.store = None
        gc.collect()

"""usher-sampled-server placement requests in a closed loop, one client.

The server is `cli/usher_socket_server_cli.py`: a `TreeCollection` that
loads the configuration's pb in set-up (the tree and its uncondensed twin,
as `--pb-to-load` does), and `handle_request` for each request's argument
line (`-i <pb> -v <request VCF> -d <outdir>`): a copy of the loaded tree, a
`PlacementEngine` (FlatMAT) over it, `placement/sampled.py::place_batch`
with its batch of 256, then the final tree and the mutation paths.  The
unix socket's framing (argument lines in, the reply and EOT out) is left
out: each request is handled in this process, as the daemon's event loop
handles it after reading it.  `handle_request` puts a failure into its
reply, so a reply that reports one, or does not end in EOT, fails the run.
"""

from __future__ import annotations

EOT = b"\x04\n"


class Driver:
    # no end-to-end reader of this driver reads a spy
    E2E_KEYS = ()

    def __init__(self, inputs: dict, traffic: dict):
        self.inputs = inputs
        self.traffic = traffic
        self.trees = None
        self.workdir = None

    def targets(self):
        """(target, key) of every call the harness times."""
        srv = "usher_tpu_torch.cli.usher_socket_server_cli:"
        drv = "usher_tpu_torch.placement.driver:"
        ps = "usher_tpu_torch.ops.placement_sparse:"
        return [(srv + "load_mat_pb", "load_pb"),
                (srv + "read_vcf", "read_vcf"),
                ("usher_tpu_torch.core.tree:Tree.copy", "copy"),
                (drv + "PlacementEngine.__init__", "flat_build"),
                (drv + "PlacementEngine.score_samples", "score"),
                ("usher_tpu_torch.placement.sampled:place_batch",
                 "place_batch"),
                (drv + "PlacementEngine.apply_placement", "apply"),
                ("usher_tpu_torch.io.newick:write_newick", "write_newick"),
                (drv + "write_mutation_paths", "mutation_paths"),
                (ps + "parent_states", "gather"),
                (ps + "score_sparse_stp_T", "b1")]

    def hooks(self, rec):
        """Record each scoring call inside the window as (samples, inside
        place_batch, seconds), and each B1 call's shapes (st [N, P], slots
        [B, K])."""
        depth = [0]
        t_enter = []

        def place(phase, *_):
            depth[0] += 1 if phase == "enter" else -1

        def score(phase, t, args, kwargs, out):
            if phase == "enter":
                t_enter.append(t)
                return
            t0 = t_enter.pop()
            if rec.live:
                rec.calls.setdefault("score", []).append(
                    (len(args[1]), depth[0] > 0, t - t0))

        def b1(phase, t, args, kwargs, out):
            if phase == "enter" and rec.live:
                st, pos = args[0], args[3]
                rec.calls.setdefault("b1", []).append(
                    (tuple(st.shape), tuple(pos.shape)))
        return {"place_batch": place, "score": score, "b1": b1}

    def setup(self) -> None:
        from usher_tpu_torch.cli.usher_socket_server_cli import TreeCollection
        from usher_tpu_torch.utils.device import apply_platform_env
        apply_platform_env()
        self.trees = TreeCollection([self.inputs["pb"]])

    def run_unit(self, k: int, outdir: str) -> int:
        from usher_tpu_torch.cli.usher_socket_server_cli import handle_request
        unit = self.inputs["units"][k]
        reply = handle_request(["-i", self.inputs["pb"], "-v", unit["vcf"],
                                "-d", outdir], self.trees)
        if b"request failed" in reply or not reply.endswith(EOT):
            raise RuntimeError(f"request {k} failed: {reply[-2000:]!r}")
        return len(unit["names"])

    def release(self) -> None:
        import gc
        self.trees = None
        gc.collect()

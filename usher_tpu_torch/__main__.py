"""Top-level dispatcher of the port: ``python -m usher_tpu_torch <tool>
[args...]`` (counterpart of usher_tpu/__main__.py, with the same tool names,
usage text and exit codes).

Maps reference binary names onto the port's CLI modules so shell scripts
written for the reference suite can switch with a one-word prefix change.
"""

from __future__ import annotations

import sys

TOOLS = {
    "usher": "usher_tpu_torch.cli.usher_cli",
    "usher-sampled": "usher_tpu_torch.cli.usher_sampled_cli",
    "matOptimize": "usher_tpu_torch.cli.matoptimize_cli",
    "matUtils": "usher_tpu_torch.cli.matutils_cli",
    "ripples": "usher_tpu_torch.cli.ripples_cli",
    "ripples-fast": "usher_tpu_torch.cli.ripples_cli",
    "ripplesInit": "usher_tpu_torch.cli.ripples_init_cli",
    "ripplesUtils": "usher_tpu_torch.cli.ripples_utils_cli",
    "ripples-filter": "usher_tpu_torch.cli.ripples_filter_cli",
    "transpose_vcf": "usher_tpu_torch.cli.transpose_vcf_cli",
    "compareVCF": "usher_tpu_torch.cli.compare_vcf_cli",
    "check_samples_place": "usher_tpu_torch.cli.check_samples_cli",
    "usher_server": "usher_tpu_torch.cli.usher_server_cli",
    "usher-sampled-server": "usher_tpu_torch.cli.usher_socket_server_cli",
    "faToVcf": "usher_tpu_torch.io.fatovcf",
}


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("usage: python -m usher_tpu_torch <tool> [args...]\n\ntools:",
              file=sys.stderr)
        for name in TOOLS:
            print(f"  {name}", file=sys.stderr)
        return 0 if len(sys.argv) >= 2 else 1
    tool = sys.argv[1]
    mod_name = TOOLS.get(tool)
    if mod_name is None:
        print(f"ERROR: unknown tool '{tool}'; run with --help for the list",
              file=sys.stderr)
        return 1
    import importlib
    mod = importlib.import_module(mod_name)
    return mod.main(sys.argv[2:])


if __name__ == "__main__":
    sys.exit(main())

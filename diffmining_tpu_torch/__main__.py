"""CLI of the port: `python -m diffmining_tpu_torch <command> ...`

    typicality  typicality sweep (typicality/compute.py CLI)

The JAX package's other commands (finetune, cluster, pnp, parallel, xray,
doersch, clipmining, html, fidelity, verify_checkpoint) come with later
slices of the port.
"""
from __future__ import annotations

import sys


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return
    cmd, rest = argv[0], argv[1:]
    if cmd == "typicality":
        from diffmining_tpu_torch.typicality.compute import main as m

        m(rest)
    else:
        raise SystemExit(f"unknown command {cmd!r}; this port has: typicality")


if __name__ == "__main__":
    main()

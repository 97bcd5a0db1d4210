"""CLI of the port: `python -m diffmining_tpu_torch <command> ...`

    finetune    --which {cars,ftt,geo,places,xray} + trainer flags
    typicality  typicality sweep (typicality/compute.py CLI)

The JAX package's other commands (cluster, pnp, parallel, xray, doersch,
clipmining, html, fidelity, verify_checkpoint) come with later slices of the
port.
"""
from __future__ import annotations

import sys


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return
    cmd, rest = argv[0], argv[1:]
    if cmd == "finetune":
        from diffmining_tpu_torch.finetuning.args import parse_args

        which = None
        if "--which" in rest:
            i = rest.index("--which")
            which = rest[i + 1]
            rest = rest[:i] + rest[i + 2:]
        if which is None:
            if "-h" in rest or "--help" in rest:
                parse_args(rest)  # argparse prints the trainer flags and exits
            raise SystemExit("finetune requires --which {cars,ftt,geo,places,xray}")
        from diffmining_tpu_torch.finetuning.base import BaseTrainer

        BaseTrainer(which, parse_args(rest)).train()
    elif cmd == "typicality":
        from diffmining_tpu_torch.typicality.compute import main as m

        m(rest)
    else:
        raise SystemExit(f"unknown command {cmd!r}; this port has: finetune, typicality")


if __name__ == "__main__":
    main()

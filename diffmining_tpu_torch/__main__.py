"""CLI of the port: `python -m diffmining_tpu_torch <command> ...`

    finetune    --which {cars,ftt,geo,places,xray} + trainer flags
    typicality  typicality sweep (typicality/compute.py CLI)
    cluster     mining: patch tables, DIFT features, k-means, ranked
                clusters and figures (typicality/cluster.py CLI)
    xray        X-ray localization eval (applications/xray.py CLI)
    pnp         PnP translation (applications/pnp.py CLI)
    parallel    typicality and mining over PnP's translations
                (applications/parallel.py CLI)
    clipmining  CLIP patch-ranking baseline (baselines/clipmining.py CLI)
    doersch     HOG+SVM mining baseline (baselines/doersch.py CLI)
    verify_checkpoint
                checks a pipeline dir: verify_checkpoint PIPELINE_DIR
                (utils/verify_checkpoint.py CLI)
    html        figure-tree HTML report: html FIGURES_DIR [OUTPUT_DIR] [NC]
    fidelity    compare typicality artifact trees: --ours A --theirs B

finetune, typicality, cluster, xray, pnp, parallel, clipmining, doersch and
verify_checkpoint run on the GPU unless given --device cpu; html and
fidelity are file and numpy work on the host. These are all 11 of the JAX
package's commands.
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
        from diffmining_tpu_torch.parallel.mesh import destroy

        try:
            BaseTrainer(which, parse_args(rest)).train()
        finally:
            destroy()
    elif cmd == "typicality":
        from diffmining_tpu_torch.typicality.compute import main as m

        m(rest)
    elif cmd == "cluster":
        from diffmining_tpu_torch.typicality.cluster import main as m

        m(rest)
    elif cmd == "xray":
        from diffmining_tpu_torch.applications.xray import main as m

        m(rest)
    elif cmd == "pnp":
        from diffmining_tpu_torch.applications.pnp import main as m

        m(rest)
    elif cmd == "parallel":
        from diffmining_tpu_torch.applications.parallel import main as m

        m(rest)
    elif cmd == "clipmining":
        from diffmining_tpu_torch.baselines.clipmining import main as m

        m(rest)
    elif cmd == "doersch":
        from diffmining_tpu_torch.baselines.doersch import main as m

        m(rest)
    elif cmd == "verify_checkpoint":
        from diffmining_tpu_torch.utils.verify_checkpoint import main as m

        raise SystemExit(m(rest))
    elif cmd == "html":
        from diffmining_tpu_torch.typicality.make_html import main as m

        m(rest)
    elif cmd == "fidelity":
        from diffmining_tpu_torch.utils.fidelity import main as m

        m(rest)
    else:
        raise SystemExit(f"unknown command {cmd!r}; this port has: finetune, typicality, cluster, xray, pnp, "
                         "parallel, clipmining, doersch, verify_checkpoint, html, fidelity")


if __name__ == "__main__":
    main()

"""Finetuning CLI for the 'xray' domain (mirrors the reference's per-domain
trainer entry point; the logic lives in base.py and datasets.py):

    python -m diffmining_tpu_torch.finetuning.xray --data_path DATA --base_name_or_path PIPELINE ...
"""
from diffmining_tpu_torch.finetuning.args import parse_args
from diffmining_tpu_torch.finetuning.base import BaseTrainer


def main(argv=None):
    return BaseTrainer("xray", parse_args(argv)).train()


if __name__ == "__main__":
    main()

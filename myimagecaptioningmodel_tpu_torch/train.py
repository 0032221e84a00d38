"""Training entry point of the port (the JAX package's ``train.py``, one
process):

    python -m myimagecaptioningmodel_tpu_torch.train [--config cfg.json] [--device cpu]

Trains on one CUDA device unless ``--device`` names another; without a card
and without ``--device cpu`` it stops with an error. Multi-GPU training
comes with a later slice (ROADMAP.md).
"""

import argparse
import pprint

from myimagecaptioningmodel_tpu_torch import config as config_mod
from myimagecaptioningmodel_tpu_torch.training import loop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, help="path to a JSON config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only when asked for)")
    args = ap.parse_args(argv)
    cfg = config_mod.Config.from_json_file(args.config) if args.config else config_mod.default
    pprint.pprint(loop.train(cfg, device=args.device))


if __name__ == "__main__":
    main()

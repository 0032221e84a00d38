"""Training entry point of the port (the JAX package's ``train.py``):

    python -m myimagecaptioningmodel_tpu_torch.train [--config cfg.json] [--device cpu]
        [--distributed [--coordinator host:port --num-processes N --process-id I]]

Trains on one CUDA device unless ``--device`` names another; without a card
and without ``--device cpu`` it stops with an error. Data parallelism runs
one process per GPU: under ``torchrun --nproc-per-node N -m
myimagecaptioningmodel_tpu_torch.train`` (its environment is joined without
flags), or with ``--distributed`` and explicit addresses on each process;
``cfg.train.batch_size`` stays the global batch (``training/loop.py``).
"""

import argparse
import pprint

from myimagecaptioningmodel_tpu_torch import config as config_mod
from myimagecaptioningmodel_tpu_torch.parallel import distributed
from myimagecaptioningmodel_tpu_torch.training import loop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, help="path to a JSON config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, this process's GPU in a group; "
                         "cpu only when asked for)")
    distributed.add_cli_arguments(ap)
    args = ap.parse_args(argv)
    distributed.initialize_from_cli(args)
    cfg = config_mod.Config.from_json_file(args.config) if args.config else config_mod.default
    try:
        summary = loop.train(cfg, device=args.device)
        if distributed.is_main_process():
            pprint.pprint(summary)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()

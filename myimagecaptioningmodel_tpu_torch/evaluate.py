"""Offline BLEU-1..4 / CIDEr-D evaluation entry point of the port (the JAX
package's ``evaluate.py``, one process):

    python -m myimagecaptioningmodel_tpu_torch.evaluate [--config cfg.json]
        [--bundle infer] [--mode dev|test] [--beam N] [--quantize]
        [--quantize-kv] [--early-stop] [--length-norm A] [--device cpu]
        [--distributed [--coordinator host:port --num-processes N --process-id I]]

Decodes on one CUDA device unless ``--device`` names another; without a card
and without ``--device cpu`` it stops with an error. In a process group
(torchrun, or ``--distributed``, as ``train``) each process decodes its rows
of every batch and every process scores the whole split.
"""

import argparse

from myimagecaptioningmodel_tpu_torch import config as config_mod
from myimagecaptioningmodel_tpu_torch.evaluation import evaluate as evaluate_mod
from myimagecaptioningmodel_tpu_torch.parallel import distributed


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, help="path to a JSON config")
    ap.add_argument("--bundle", default="infer", help="inference bundle name")
    ap.add_argument("--mode", default="test", choices=["dev", "test"],
                    help="which split to score (reference evaluates test)")
    ap.add_argument("--beam", type=int, default=0, help="beam size (0/1 = greedy)")
    ap.add_argument("--quantize", action="store_true", help="int8 decoder weights")
    ap.add_argument("--quantize-kv", action="store_true",
                    help="int8 cross-attention K/V (transformer, greedy; approximate)")
    ap.add_argument("--early-stop", action="store_true",
                    help="greedy decode exits once every row emitted <stop> (same captions)")
    ap.add_argument("--length-norm", type=float, default=0.0,
                    help="beam only: normalize final scores by len**alpha (0 = off)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only when asked for)")
    distributed.add_cli_arguments(ap)
    args = ap.parse_args(argv)
    distributed.initialize_from_cli(args)
    cfg = config_mod.Config.from_json_file(args.config) if args.config else config_mod.default
    try:
        evaluate_mod.evaluate(
            cfg, bundle=args.bundle, mode=args.mode, beam_size=args.beam,
            quantize=args.quantize, early_stop=args.early_stop, length_norm=args.length_norm,
            quantize_kv=args.quantize_kv, device=args.device)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()

"""Evaluate a classification checkpoint.

Counterpart of ``fastvim_tpu/cli/test_classification.py``:
  python -m fastvim_tpu_torch.cli.test_classification --config_name \
      FastVimT --checkpoint out/ckpt/step_N [--ema] [--device cpu]

Prints and returns ``{"test_loss", "test_acc"}``: the means over the val
loader's batches. The model takes the config's architecture fields, as
the train CLI builds it. Under ``torchrun`` each rank evaluates its
share of the batches, and the means are taken over all of them.
"""

from __future__ import annotations

import numpy as np
import torch

from fastvim_tpu_torch.cli.common import (
    base_parser,
    cli_device,
    load_cli_config,
    setup_mesh,
)


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--checkpoint", required=False, default=None)
    p.add_argument("--ema", action="store_true",
                   help="evaluate the EMA weights")
    args = p.parse_args(argv)
    cfg = load_cli_config(args, "classification")
    device = cli_device(args.device)
    setup_mesh(device)

    from fastvim_tpu_torch.cli.train_classification import create_classifier
    from fastvim_tpu_torch.data import create_imagenet_loader
    from fastvim_tpu_torch.parallel import gather_objects, is_writer
    from fastvim_tpu_torch.train import make_supervised_eval_step
    from fastvim_tpu_torch.train.checkpoint import restore_checkpoint
    from fastvim_tpu_torch.train.loop import to_device

    model = create_classifier(cfg, device, drop_path_rate=0.0)
    if args.checkpoint:
        restored = restore_checkpoint(args.checkpoint, device)
        key = "ema_params" if args.ema and "ema_params" in restored else \
            "params"
        model.load_state_dict(restored[key])

    loader = create_imagenet_loader(
        cfg["data"].get("dir"), "val", cfg["batch_size"], cfg["img_size"],
        training=False, synthetic_samples=args.synthetic_samples)
    eval_step = make_supervised_eval_step(model)
    per_batch = []
    for batch in loader:
        m = eval_step(to_device(batch, device))
        per_batch.append(torch.stack([m["loss"], m["acc"]]))
    per_batch = gather_objects(torch.stack(per_batch).tolist()
                               if per_batch else [])
    losses, accs = zip(*per_batch)
    result = {"test_loss": float(np.mean(losses)),
              "test_acc": float(np.mean(accs))}
    if is_writer():
        print(result)
    return result


if __name__ == "__main__":
    main()

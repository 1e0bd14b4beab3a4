"""Quickstart on the PyTorch port: train a small transformer LM with
WASGD+ (4 workers), as ``examples/quickstart.py`` does with the JAX
package.

    PYTHONPATH=src python examples/torch_quickstart.py                # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Shows the full public API path: config -> init -> Trainer(rule="wasgd") ->
order-managed data pipeline -> checkpoint save/restore.
"""
import argparse

import numpy as np
import torch

from repro_torch.checkpoint import restore, save
from repro_torch.configs import TrainConfig, WASGDConfig, get_smoke_config
from repro_torch.data import OrderedDataset, make_tokens
from repro_torch.models import init_params, param_axes
from repro_torch.train import Trainer, make_lm_loss
from repro_torch.tree import tree_map


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--ckpt", default="/tmp/wasgd_quickstart_ckpt")
    args = ap.parse_args(argv)

    cfg = get_smoke_config("stablelm-1.6b")
    print(f"model: {cfg.name}  params={cfg.param_count():,}")

    p_workers, tau, b_local, seq = 4, 4, 2, 64
    tcfg = TrainConfig(
        learning_rate=0.03, optimizer="sgd",
        wasgd=WASGDConfig(tau=tau, beta=0.9, a_tilde=1.0,
                          strategy="boltzmann"))

    # synthetic bigram language (offline container) — tokens/labels pairs
    toks = make_tokens(0, 2048, seq, cfg.vocab_size)
    data = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ds = OrderedDataset(data, p_workers, tau, b_local, n_segments=2)

    params = init_params(cfg, 0, device=args.device)
    trainer = Trainer(make_lm_loss(cfg), params, param_axes(params), tcfg,
                      p_workers, rule="wasgd", device=args.device)
    trainer.run(ds.batches(), n_rounds=args.rounds, order_state=ds.order,
                segment_fn=ds.segment_of_round, log_every=5)

    losses = trainer.losses()
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(theta of last round: {np.round(trainer.history[-1]['theta'], 3)})")
    assert losses[-1] < losses[0], "training should reduce loss"

    save(args.ckpt, trainer.state.params,
         meta={"rounds": args.rounds, "arch": cfg.name})
    restored, meta = restore(args.ckpt,
                             tree_map(torch.zeros_like, trainer.state.params))
    print(f"checkpoint round-trip OK (meta={meta})")
    return trainer, restored


if __name__ == "__main__":
    main()

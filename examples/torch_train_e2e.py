"""End-to-end training driver on the PyTorch port, as
``examples/train_e2e.py`` drives the JAX package: a ~100M-parameter dense
LM trained with WASGD+ for a configurable number of rounds, with metrics
JSONL, periodic checkpoints, and held-out evaluation of the aggregated
consensus model.

    # smoke-scale (seconds):
    PYTHONPATH=src python examples/torch_train_e2e.py --smoke --rounds 10 \\
        --device cpu

    # the real thing (~100M params, on the card):
    PYTHONPATH=src python examples/torch_train_e2e.py --rounds 300
"""
import argparse
import dataclasses

from repro_torch.configs import ModelConfig, TrainConfig, WASGDConfig
from repro_torch.data import OrderedDataset, make_tokens
from repro_torch.models import init_params, param_axes
from repro_torch.train import Trainer, make_lm_loss
from repro_torch.train.evaluate import consensus_params, evaluate_lm


def model_100m() -> ModelConfig:
    """~100M dense decoder (12L x 640, vocab 32k)."""
    return ModelConfig(
        name="wasgd-100m", family="dense", n_layers=12, d_model=640,
        n_heads=10, n_kv_heads=10, head_dim=64, d_ff=2560, vocab_size=32000,
        compute_dtype="float32", remat=False,
        source="examples/train_e2e.py (paper-scale driver)")


def model_smoke() -> ModelConfig:
    return dataclasses.replace(model_100m(), name="wasgd-e2e-smoke",
                               n_layers=2, d_model=128, n_heads=4,
                               n_kv_heads=4, head_dim=32, d_ff=512,
                               vocab_size=1024)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--tau", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--b-local", type=int, default=4)
    ap.add_argument("--metrics", default="/tmp/wasgd_e2e_metrics.jsonl")
    ap.add_argument("--ckpt", default="/tmp/wasgd_e2e_ckpt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = model_smoke() if args.smoke else model_100m()
    print(f"model={cfg.name} params={cfg.param_count():,} "
          f"workers={args.workers} tau={args.tau}")

    toks = make_tokens(0, 4096, args.seq, cfg.vocab_size)
    data = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ds = OrderedDataset(data, args.workers, args.tau, args.b_local,
                        n_segments=2)
    params = init_params(cfg, 0, device=args.device)
    tcfg = TrainConfig(learning_rate=0.02, optimizer="sgd",
                       wasgd=WASGDConfig(tau=args.tau, beta=0.9, a_tilde=1.0))
    trainer = Trainer(make_lm_loss(cfg), params, param_axes(params), tcfg,
                      args.workers, device=args.device)
    summary = trainer.run(
        ds.batches(), args.rounds, order_state=ds.order,
        segment_fn=ds.segment_of_round,
        log_every=max(1, args.rounds // 10),
        metrics_path=args.metrics,
        checkpoint_every=max(1, args.rounds // 2),
        checkpoint_path=args.ckpt)
    print(f"train: {summary}")

    # evaluate the served consensus copy on held-out data
    served = consensus_params(trainer.state.params, trainer.axes)
    held = make_tokens(999, 256, args.seq, cfg.vocab_size)

    def eval_batches():
        i = 0
        while True:
            sl = held[(i * 16) % 240:(i * 16) % 240 + 16]
            yield {"tokens": sl[:, :-1], "labels": sl[:, 1:]}
            i += 1

    metrics = evaluate_lm(cfg, served, eval_batches(), n_batches=4)
    print(f"held-out: {metrics}")
    return trainer, metrics


if __name__ == "__main__":
    main()

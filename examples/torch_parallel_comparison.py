"""Benchmark-style comparison of all seven parallel SGD methods from the
paper (Sec. 5.2.2) on synthetic classification, on the PyTorch port, as
``examples/parallel_comparison.py`` runs them with the JAX package — a
small rendition of Figure 8.

    PYTHONPATH=src python examples/torch_parallel_comparison.py   # card
    PYTHONPATH=src python examples/torch_parallel_comparison.py --device cpu
"""
import argparse

from repro_torch.configs import TrainConfig, WASGDConfig
from repro_torch.core import shared_axes
from repro_torch.data import OrderedDataset, make_classification
from repro_torch.models import classification_loss, init_mlp, mlp_apply
from repro_torch.train import Trainer

METHODS = [
    ("SGD (sequential)", "seq", {}),
    ("SPSGD", "spsgd", {}),
    ("EASGD", "easgd", {}),
    ("OMWU", "omwu", {}),
    ("MMWU", "mmwu", {}),
    ("WASGD (1/h)", "wasgd", dict(strategy="inverse", beta=1.0)),
    ("WASGD+ (Boltzmann)", "wasgd", dict(strategy="boltzmann", beta=0.9,
                                         a_tilde=1.0)),
    # same rule through a different aggregation backend (core/backends.py) —
    # WASGDConfig.backend selects it end-to-end through the train step.
    ("WASGD+ (int8 comm)", "wasgd", dict(strategy="boltzmann", beta=0.9,
                                         a_tilde=1.0, backend="quantized")),
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=25)
    args = ap.parse_args(argv)

    X, y = make_classification(0, 8192, d=64, n_classes=10, noise=0.25)
    params = init_mlp(0, 64, 128, 10, device=args.device)
    axes = shared_axes(params)

    def loss_fn(p, batch):
        return classification_loss(mlp_apply(p, batch["x"]),
                                   batch["y"]), {}

    p_workers, tau, rounds = 4, 8, args.rounds
    print(f"{'method':24s} {'first':>8s} {'final':>8s}")
    results = {}
    for label, rule, kw in METHODS:
        tcfg = TrainConfig(learning_rate=0.05,
                           wasgd=WASGDConfig(tau=tau, **kw))
        ds = OrderedDataset({"x": X, "y": y}, p_workers, tau, 8,
                            n_segments=2, seed=7)
        tr = Trainer(loss_fn, params, axes, tcfg, p_workers, rule=rule,
                     device=args.device)
        use_order = label.endswith("+ (Boltzmann)")
        tr.run(ds.batches(), rounds,
               order_state=ds.order if use_order else None,
               segment_fn=ds.segment_of_round if use_order else None)
        losses = tr.losses()
        results[label] = losses[-1]
        print(f"{label:24s} {losses[0]:8.4f} {losses[-1]:8.4f}")

    best = min(results, key=results.get)
    print(f"\nbest: {best}")
    return results


if __name__ == "__main__":
    main()

"""Training launcher, the counterpart of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --smoke --workers 4 --rounds 20 --device cpu

The same flags, defaults and printed lines as the JAX launcher, less one
flag and plus one:

* ``--transfer-guard`` is JAX-only: it runs each jitted round under
  ``jax.transfer_guard``, and a torch round has no jitted program to
  guard (the port's rounds move each batch to the device explicitly, and
  nothing else crosses).
* ``--device`` (default ``cuda``) is where the run trains; ``cpu`` runs
  the kernels' plain versions.

Like JAX's, it builds no mesh: every worker is a row of one device. The
``Trainer(mesh=)`` of ``train/trainer.py`` is the decentralized form.
``main(argv)`` takes the arguments as a list, so that a caller can run
the launcher in its own process.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from repro_torch.checkpoint import save
from repro_torch.configs import (TrainConfig, WASGDConfig, get_config,
                                 get_smoke_config)
from repro_torch.data import OrderedDataset, RoundPrefetcher, make_tokens
from repro_torch.models import init_params, param_axes
from repro_torch.train import Trainer, make_lm_loss


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--tau", type=int, default=4)
    ap.add_argument("--beta", type=float, default=0.9)
    ap.add_argument("--a-tilde", type=float, default=1.0)
    ap.add_argument("--strategy", default="boltzmann",
                    choices=["boltzmann", "inverse", "equal", "best"])
    ap.add_argument("--policy", default="",
                    help="worker-assessment policy spec (core/weights.py), "
                         "e.g. 'boltzmann(a=8)|anneal(cosine)', "
                         "'ema(0.9)|time_aware', 'trimmed(1)|boltzmann'; "
                         "empty resolves --strategy/--a-tilde as aliases")
    ap.add_argument("--rule", default="wasgd",
                    choices=["wasgd", "spsgd", "easgd", "omwu", "mmwu", "seq"])
    ap.add_argument("--lr", type=float, default=0.03)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--b-local", type=int, default=2)
    ap.add_argument("--ckpt", default=None,
                    help="write a final params-only flat checkpoint here")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory for periodic full-state sharded "
                         "checkpoints (checkpoint-dir/round_N); saved "
                         "asynchronously every --checkpoint-every rounds")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="rounds between sharded checkpoints "
                         "(0 = disabled; requires --checkpoint-dir)")
    ap.add_argument("--resume", default=None,
                    help="resume from a sharded checkpoint (a "
                         "checkpoint-dir/round_N path); a checkpoint saved "
                         "under a different --workers count is resized "
                         "into this run's membership on restore")
    ap.add_argument("--chaos", type=int, default=0, metavar="SEED",
                    help="run under a seeded elastic membership chaos "
                         "schedule (core/membership.make_chaos_schedule; "
                         "0 = fixed membership)")
    ap.add_argument("--telemetry", default=None, metavar="PATH",
                    help="record structured telemetry to this JSONL file "
                         "(repro_torch.obs.JsonlSink): per-round RoundTrace "
                         "phase breakdowns + WorkerAssessment, plus "
                         "membership/checkpoint events; summarize with "
                         "tools/obs_report.py")
    ap.add_argument("--pipeline", default=None,
                    choices=["parity", "speculative"],
                    help="software-pipeline the round (train/step.py): "
                         "prefetch round r+1 and feed its first microbatch "
                         "into the aggregation schedule's phase-gap seam; "
                         "'parity' is bitwise-identical to unpipelined, "
                         "'speculative' also runs the next Judge forward on "
                         "pre-aggregate params (wasgd/wasgd+ rules only)")
    ap.add_argument("--device", default="cuda",
                    help="device to train on: cuda (the CUDA kernels) or "
                         "cpu (their plain versions)")
    return ap


def main(argv: Optional[List[str]] = None) -> Trainer:
    """Runs the launcher on ``argv`` (default: the command line) and
    returns the trainer."""
    args = build_parser().parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params={cfg.param_count():,} workers={args.workers}")

    tcfg = TrainConfig(
        learning_rate=args.lr, optimizer="sgd",
        wasgd=WASGDConfig(tau=args.tau, beta=args.beta, a_tilde=args.a_tilde,
                          strategy=args.strategy, policy=args.policy))

    toks = make_tokens(0, 2048, args.seq, cfg.vocab_size)
    data = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.n_codebooks:
        rng = np.random.default_rng(0)
        t = rng.integers(0, cfg.vocab_size,
                         (2048, args.seq + 1, cfg.n_codebooks), dtype=np.int32)
        data = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    if cfg.n_media_tokens:
        data["media"] = np.random.default_rng(1).normal(
            size=(2048, cfg.n_media_tokens, cfg.d_model)).astype(np.float32)

    ds = OrderedDataset(data, args.workers, args.tau, args.b_local,
                        n_segments=2,
                        boundary_delay=RoundPrefetcher.run_ahead()
                        if args.pipeline else 0)
    params = init_params(cfg, seed=0, device=args.device)
    trainer = Trainer(make_lm_loss(cfg), params, param_axes(params), tcfg,
                      args.workers, rule=args.rule, device=args.device,
                      pipeline=args.pipeline)
    del params
    membership = None
    if args.chaos:
        from repro_torch.core.membership import make_chaos_schedule
        membership = make_chaos_schedule(args.workers, args.rounds,
                                         seed=args.chaos)
        print(f"chaos membership: {membership}")
    if args.checkpoint_every and not args.checkpoint_dir:
        raise SystemExit("--checkpoint-every requires --checkpoint-dir")
    sink = None
    if args.telemetry:
        from repro_torch.obs import JsonlSink
        sink = JsonlSink(args.telemetry)
    try:
        summary = trainer.run(ds, args.rounds,
                              log_every=max(1, args.rounds // 5),
                              checkpoint_every=args.checkpoint_every,
                              checkpoint_path=args.checkpoint_dir,
                              membership_schedule=membership,
                              resume_from=args.resume,
                              telemetry=sink)
    finally:
        if sink is not None:
            sink.close()
            print(f"telemetry: {sink.n_emitted} events -> {args.telemetry}")
    print(f"done: {summary}")
    if args.ckpt:
        save(args.ckpt, trainer.state.params,
             meta={"arch": cfg.name, "rounds": args.rounds})
        print(f"checkpoint written to {args.ckpt}")
    return trainer


if __name__ == "__main__":
    main()

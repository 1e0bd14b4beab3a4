"""Serving demo on the PyTorch port, as ``examples/serve_demo.py`` runs
the JAX package: continuous batching on a paged KV cache.

Part 1 submits a ragged mix of requests (different prompt positions,
budgets, temperatures) to `ContinuousEngine` — more requests than slots, so
the scheduler inserts and evicts at token boundaries while the paged cache
recycles blocks. Part 2 hot-swaps the engine's params mid-generation, the
way `Trainer.run(serve_hook=)` pushes fresh consensus weights into a live
engine. Part 3 keeps the legacy monolithic `ServeEngine` for the media
archs (cross-attention / codebook heads) the paged engine does not serve.

    PYTHONPATH=src python examples/torch_serve_demo.py                # card
    PYTHONPATH=src python examples/torch_serve_demo.py --device cpu
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import lm_batch
from repro_torch.models import init_params
from repro_torch.serve import ContinuousEngine, HotSwapBridge, ServeEngine
from repro_torch.tree import tree_map


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device

    # --- continuous batching across cache regimes -------------------------
    for arch in ["yi-6b", "gemma3-1b", "mamba2-370m"]:
        cfg = _cfg(arch)
        params = init_params(cfg, 0, device=dev)
        engine = ContinuousEngine(cfg, params, n_slots=2, max_len=128,
                                  block_size=16, cache_dtype=torch.float32,
                                  chunk=8, device=dev)
        prompts = np.asarray(lm_batch(0, 5, 16, cfg.vocab_size)["tokens"])
        budgets = [4, 24, 9, 16, 2]          # ragged: finish at odd times
        rids = [engine.submit(prompts[i], budgets[i],
                              temperature=0.0 if i % 2 == 0 else 0.8,
                              seed=i) for i in range(5)]
        done = engine.run()
        kind = ("SSM state" if cfg.ssm is not None else
                f"window={cfg.attn_window}" if cfg.attn_window else "full KV")
        lens = [len(done[r]) for r in rids]
        print(f"{arch:14s} [{kind:12s}] 5 requests on 2 slots, "
              f"lens={lens} head={done[rids[1]][:6].tolist()}")
        assert lens == budgets and engine.scheduler.idle

    # --- live hot-swap: params change mid-flight, request survives --------
    cfg = _cfg("gemma3-1b")
    params = init_params(cfg, 1, device=dev)
    engine = ContinuousEngine(cfg, params, n_slots=2, max_len=128,
                              block_size=16, cache_dtype=torch.float32,
                              chunk=8, device=dev)
    HotSwapBridge(engine)
    prompt = np.asarray(lm_batch(1, 1, 16, cfg.vocab_size)["tokens"])[0]
    rid = engine.submit(prompt, n_new=32)
    engine.step()                                     # decode one chunk
    fresh = tree_map(lambda p: p * 0.999, params)     # "newly trained"
    engine.swap_params(fresh)
    out = engine.run()[rid]
    print(f"hot-swap        request survived the swap: {len(out)} tokens, "
          f"{engine.n_swaps} swap(s)")
    assert len(out) == 32

    # --- media archs stay on the legacy monolithic engine -----------------
    for arch in ["llama-3.2-vision-11b", "musicgen-large"]:
        cfg = _cfg(arch)
        params = init_params(cfg, 2, device=dev)
        legacy = ServeEngine(cfg, params, max_len=64,
                             cache_dtype=torch.float32, device=dev)
        batch = lm_batch(2, 2, 8, cfg.vocab_size,
                         n_codebooks=cfg.n_codebooks,
                         media_tokens=cfg.n_media_tokens, d_model=cfg.d_model)
        media = (np.asarray(batch["media"], np.float32)
                 if "media" in batch else None)
        out = legacy.generate(np.asarray(batch["tokens"]), n_new=6,
                              media=media)
        print(f"{arch:20s} [legacy engine] out shape={out.shape}")
    print("serving demo OK")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel to its plain PyTorch version on the card, times them, serves
full-width gemma3-1b (random weights from a seed) through
``ContinuousEngine``, trains the paper's CNN6 with synchronous WASGD+
through ``Trainer.run``, and checks that the served and the trained paths
went through their kernels. Prints one JSON object per phase:

  env           card, power limit, torch/CUDA versions, build time, ptxas
  kernel_check  paged_decode_attn vs its plain version over layouts, dtypes
                and shapes
  kernel_time   paged_decode_attn, plain version, library call and bound at
                the serve run's shapes
  wagg_check    wagg_fused vs its plain version over x dtype x payload x
                mask x p x N
  wagg_time     wagg_fused, plain version, two-call library reference and
                bound at the CNN6 round's leaves and at a gemma3-1b MLP leaf
  agree         full-width decode steps through the kernel vs through the
                plain version: logits agree, all finite
  serve         ContinuousEngine on gemma3-1b: tokens, tokens/s, peak memory,
                launches == 26 x decode steps
  serve_profile device busy time and idle share of a serve run (profiler)
  train_agree   one CNN6 round through pallas_wagg vs through einsum, in
                the f32 and int8 codecs: params agree
  train         Trainer.run, WASGD+, CNN6 at its published width, p=8,
                tau=8, 30 rounds: seconds per round, losses, peak memory,
                launches == rounds x 6 worker leaves
  train_profile device busy time and idle share of 5 training rounds

then the ``kernels`` summary, the card's name and power limit as
nvidia-smi gives them, and ``{"ok": true, "device": {...}}`` as the last
line. Any failed check raises and the script exits non-zero. Without a
card, or outside a checkout of the repository, it exits non-zero and
prints no result.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # float32 outside the tensor cores

ARCH = "gemma3-1b"
N_SLOTS, MAX_LEN, BLOCK, CHUNK = 4, 1024, 16, 32
# (prompt, new tokens); more requests than slots, and (480, 96) wraps the
# 512-token ring of the local layers
REQUESTS = [(32, 64), (100, 16), (480, 96), (17, 128), (256, 8), (64, 40)]
TOL = {"bfloat16": 2e-2, "float32": 1e-4}

# WASGD+ training of the paper's CNN6 (Sec. 5.2.1): 28x28x1 images, 10
# classes, published widths
TRAIN = {"p": 8, "tau": 8, "b_local": 64, "lr": 0.05, "rounds": 30,
         "n_images": 8192, "n_segments": 2, "order_seed": 7,
         "backend": "pallas_wagg:f32"}
CNN6_LEAVES = 6
# wagg_fused vs its plain version: relative to max|plain|
WAGG_TOL = {"float32": 1e-6, "bfloat16": 1e-2}
LM_LEAF = (4, 1152 * 6912)      # p=4 workers x one gemma3-1b MLP matrix


def emit(obj):
    print(json.dumps(obj), flush=True)


def run_phase(fn, *args):
    """Runs one phase, stamps its seconds and prints its record."""
    t0 = time.perf_counter()
    rec = fn(*args)
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    return rec


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(lines):
    """Pairs each compiled entry (template arguments of the mangled name)
    with its ptxas register/stack/spill line."""
    out, entry = [], None
    for ln in lines:
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            start = max(name.find("paged_decode"), name.find("wagg_fused"),
                        0)
            entry = name[start:name.find("EvPK")]
        elif "Used" in ln and entry is not None:
            out.append([entry, ln.split(":", 1)[1].strip()])
            entry = None
    return out


def assert_close(name, out, ref, tol):
    import torch
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"{name}: non-finite output")
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
    return err


def paged_inputs(b, kv, g, hd, n_blk, q_dtype, kv_dtype, gen, dev,
                 trash_row=None):
    """Random q and pools and a shuffled block table; ``trash_row`` points a
    whole row of the table at the trash block (the last pool row)."""
    import torch
    n_pool = b * n_blk + 1
    q = torch.randn(b, kv, g, hd, generator=gen, device=dev).to(q_dtype)
    kp = torch.randn(n_pool, BLOCK, kv, hd, generator=gen,
                     device=dev).to(kv_dtype)
    vp = torch.randn(n_pool, BLOCK, kv, hd, generator=gen,
                     device=dev).to(kv_dtype)
    tab = torch.randperm(b * n_blk, generator=gen, device=dev)
    tab = tab.reshape(b, n_blk).to(torch.int32)
    if trash_row is not None:
        tab[trash_row] = n_pool - 1
    return q, kp, vp, tab


def phase_kernel_check(dev):
    import torch
    from repro_torch.kernels.decode_attn import (paged_decode_attn,
                                                 paged_decode_attn_ref)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    checks = []
    b = 5
    # gemma3-1b's attention, and a wider GQA shape
    for kv, g, hd in ((1, 4, 256), (2, 8, 128)):
        for layout, n_blk, ring, window, index in (
                ("linear", 64, None, None, [0, 37, 511, 700, 1023]),
                ("ring512", 32, 512, 512, [0, 37, 511, 700, 2047]),
                ("ring512_window384", 32, 512, 384, [0, 37, 511, 700, 2047])):
            for qd, kd in ((torch.bfloat16, torch.bfloat16),
                           (torch.float32, torch.bfloat16),
                           (torch.float32, torch.float32)):
                q, kp, vp, tab = paged_inputs(b, kv, g, hd, n_blk, qd, kd,
                                              gen, dev, trash_row=b - 1)
                idx = torch.tensor(index, dtype=torch.int32, device=dev)
                out = paged_decode_attn(q, kp, vp, tab, idx, ring=ring,
                                        window=window)
                ref = paged_decode_attn_ref(q, kp, vp, tab, idx, ring=ring,
                                            window=window)
                torch.cuda.synchronize()
                tol = TOL[str(qd).split(".")[1]]
                name = (f"kv{kv}_g{g}_hd{hd}_{layout}_"
                        f"{str(qd).split('.')[1]}/{str(kd).split('.')[1]}")
                checks.append({"case": name, "index": index,
                               "max_abs_err": assert_close(name, out, ref,
                                                           tol),
                               "tol": tol})
    return {"phase": "kernel_check", "rows_at_trash_block": [b - 1],
          "tol_reason": "bf16 output: one bf16 ulp of a value below 4 is at "
                        "most 2^-6; f32: summation order over <= 1024 tokens",
            "checks": checks}


def graph_ms(fns, reps_per_graph, replays=10):
    """Device time of one call: the calls ``fns`` (one per working set, so
    the sets together exceed the 50 MB L2 as a decode step's layers do)
    captured into a CUDA graph, replayed, timed with CUDA events."""
    import torch
    for f in fns:
        f()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns[:2]:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps_per_graph):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps_per_graph)


def phase_kernel_time(dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn import (paged_decode_attn,
                                                 paged_decode_attn_ref)
    from repro_torch.kernels.decode_attn.ref import slot_valid
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    b, kv, g, hd = N_SLOTS, 1, 4, 256
    index = [100, 480, 575, 1000]
    idx = torch.tensor(index, dtype=torch.int32, device=dev)
    n_sets = 32
    res = {}
    for layout, n_blk, ring in (("ring512", 32, 512), ("linear", 64, None)):
        S = n_blk * BLOCK
        sets = [paged_inputs(b, kv, g, hd, n_blk, torch.bfloat16,
                             torch.bfloat16, gen, dev) for _ in range(n_sets)]
        valid = slot_valid(torch.arange(S, device=dev)[None, :],
                           idx.long()[:, None], ring, ring)
        gathered = []
        for q, kp, vp, tab in sets:
            k = kp[tab.long()].reshape(b, S, kv, hd).transpose(1, 2)
            v = vp[tab.long()].reshape(b, S, kv, hd).transpose(1, 2)
            gathered.append((q.reshape(b, kv * g, 1, hd),
                             k.expand(b, kv * g, S, hd).contiguous(),
                             v.expand(b, kv * g, S, hd).contiguous()))
        mask = valid[:, None, None, :]

        def kern(s):
            return lambda: paged_decode_attn(*s, idx, ring=ring, window=ring)

        def plain(s):
            return lambda: paged_decode_attn_ref(*s, idx, ring=ring,
                                                 window=ring)

        def library(s):
            return lambda: F.scaled_dot_product_attention(
                s[0], s[1], s[2], attn_mask=mask)

        ms = graph_ms([kern(s) for s in sets], n_sets)
        plain_ms = graph_ms([plain(s) for s in sets], n_sets)
        library_ms = graph_ms([library(s) for s in gathered], n_sets)
        q, kp, vp, tab = sets[0]
        out = paged_decode_attn(q, kp, vp, tab, idx, ring=ring, window=ring)
        ref = paged_decode_attn_ref(q, kp, vp, tab, idx, ring=ring,
                                    window=ring)
        lib = F.scaled_dot_product_attention(*gathered[0], attn_mask=mask)
        err = assert_close(f"time/{layout}", out, ref, TOL["bfloat16"])
        lib_err = (lib.reshape(out.shape).float() - ref.float()).abs().max()
        n_valid = int(valid.sum().item())
        elem = 2                                        # bf16
        bytes_moved = (2 * q.numel() * elem             # q in, out out
                       + 2 * n_valid * kv * hd * elem   # valid K and V rows
                       + tab.numel() * 4 + idx.numel() * 4)
        flops = 4 * n_valid * kv * g * hd               # q.k and p.v
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        res[layout] = {
            "shape": {"b": b, "kv": kv, "g": g, "hd": hd, "bs": BLOCK,
                      "n_blk": n_blk, "ring": ring, "index": index,
                      "dtypes": "bfloat16/bfloat16"},
            "valid_tokens": n_valid, "bytes": bytes_moved, "flops": flops,
            "max_abs_err": err, "library_max_abs_err": float(lib_err),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "working_sets": n_sets}
    return {"phase": "kernel_time",
            "method": "CUDA graph of 32 calls on 32 distinct working sets "
                      "(> 50 MB L2), 10 replays, CUDA events", **res}


def phase_agree(cfg, params_f32, dev):
    """A few full-width decode steps through the kernel and through the
    plain version, on the same caches and tokens."""
    import torch
    from repro_torch.kernels.decode_attn import (paged_decode_attn,
                                                 paged_decode_attn_ref)
    from repro_torch.models import (cast_params, decode_step_paged,
                                    init_cache, prefill)
    from repro_torch.serve import PagedCache
    steps = 4
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (600, 37)]                 # 600 wraps the ring
    feed = rng.integers(0, cfg.vocab_size, (steps, 2, 1)).astype(np.int32)
    results = []
    for dtype, limit in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        c = dataclasses.replace(cfg, compute_dtype=str(dtype).split(".")[1])
        params = cast_params(params_f32, dtype)
        caches = [PagedCache(c, 2, MAX_LEN, BLOCK, dtype=dtype, device=dev)
                  for _ in range(2)]
        for slot, p in enumerate(prompts):
            mono = init_cache(c, 1, MAX_LEN, dtype, dev)
            prefill(c, params, torch.from_numpy(p[None]).to(dev), mono)
            for cache in caches:
                cache.reserve(slot, len(p) + steps)
                cache.write_prefill(slot, mono, len(p))
        index = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                             device=dev)
        worst = 0.0
        for t in range(steps):
            tok = torch.from_numpy(feed[t]).to(dev)
            lg = [decode_step_paged(c, params, tok, cache.pools, cache.tables,
                                    index, max_len=MAX_LEN, block_size=BLOCK,
                                    attn_kernel=kern)[0].float()
                  for cache, kern in zip(caches, (paged_decode_attn,
                                                  paged_decode_attn_ref))]
            if not (bool(torch.isfinite(lg[0]).all())
                    and bool(torch.isfinite(lg[1]).all())):
                raise AssertionError(f"agree/{dtype}: non-finite logits")
            if lg[0].shape != (2, 1, cfg.padded_vocab):
                raise AssertionError(f"agree: logits shape {lg[0].shape}")
            rel = ((lg[0] - lg[1]).abs().max()
                   / lg[1].abs().max()).item()
            worst = max(worst, rel)
            index += 1
        if not worst <= limit:
            raise AssertionError(f"agree/{dtype}: rel_err {worst} > {limit}")
        results.append({"dtype": str(dtype).split(".")[1], "rel_err": worst,
                        "limit": limit})
        del params, caches
    return {"phase": "agree", "prompts": [len(p) for p in prompts],
            "decode_steps": steps, "finite": True, "checks": results,
            "limit_reason": "f32: summation order; bf16: one-ulp differences "
                            "in attention outputs carried through 26 layers"}


def serve_requests(cfg, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, p).astype(np.int32), n)
            for p, n in REQUESTS]


def run_engine(eng, reqs):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, n) for p, n in reqs]
    done = eng.run()
    torch.cuda.synchronize()
    return [done[r] for r in rids], time.perf_counter() - t0


def phase_serve(cfg, eng):
    import torch
    from repro_torch.kernels.decode_attn import paged_decode_attn
    n_attn = sum(cfg.layer_is_attn(i) for i in range(cfg.n_layers))
    run_engine(eng, [(p[:16], 4) for p, _ in serve_requests(cfg, 99)[:2]])
    reqs = serve_requests(cfg, 0)
    torch.cuda.reset_peak_memory_stats()
    paged_decode_attn.launches = 0
    eng.decode_steps = 0
    outs, wall = run_engine(eng, reqs)
    launches, steps = paged_decode_attn.launches, eng.decode_steps
    if launches == 0 or launches != n_attn * steps:
        raise AssertionError(f"serve: {launches} kernel launches for {steps} "
                             f"decode steps x {n_attn} attention layers")
    for (p, n), toks in zip(reqs, outs):
        if toks.shape != (n,) or toks.min() < 0 \
                or toks.max() >= cfg.padded_vocab:
            raise AssertionError(f"serve: bad output for request "
                                 f"({len(p)}, {n}): {toks}")
    tokens = sum(len(t) for t in outs)
    return {"phase": "serve", "arch": cfg.name, "dtype": cfg.compute_dtype,
           "n_slots": N_SLOTS, "max_len": MAX_LEN, "block_size": BLOCK,
           "chunk": CHUNK, "requests": REQUESTS, "decode_steps": steps,
           "attn_layers": n_attn, "launches": launches, "tokens": tokens,
           "wall_s": wall, "tokens_per_s": tokens / wall,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_serve_profile(cfg, eng):
    """One more serve run under torch.profiler: device busy time (sum of
    kernel times on the one stream) against the wall of an unprofiled run
    of the same requests."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    reqs = serve_requests(cfg, 0)
    _, wall = run_engine(eng, reqs)
    # device activity only: host events of a run this long take minutes
    # to post-process
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall_prof = run_engine(eng, reqs)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    return {"phase": "serve_profile", "wall_ms": wall * 1e3,
            "wall_ms_profiled": wall_prof * 1e3, "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / (wall * 1e3)
                                  if busy_ms > 0 else None),
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "device_ms": dev_us(e) / 1e3} for e in top]}


def wagg_inputs(p, n, x_dtype, payload, mask, gen, dev):
    """x (p, n), theta (p,) positive summing to 1 (the int8 codec's scale
    folded in when the payload is int8), payload and an activity mask."""
    import torch
    x = torch.randn(p, n, generator=gen, device=dev).to(x_dtype)
    theta = torch.rand(p, generator=gen, device=dev) + 0.05
    theta = theta / theta.sum()
    q = None
    if payload == "bfloat16":
        q = torch.randn(p, n, generator=gen, device=dev).to(torch.bfloat16)
    elif payload == "int8":
        q = torch.randint(-127, 128, (p, n), generator=gen, device=dev,
                          dtype=torch.int8)
        theta = theta * (4.0 / 127.0)
    act = None
    if mask == "mixed":
        act = (torch.arange(p, device=dev) % 3 != 1).float()
    elif mask == "one_active":
        act = torch.zeros(p, device=dev)
        act[p // 2] = 1.0
    return x, theta, q, act


def rel_err(out, ref):
    """max |out - ref| over max |ref|, in float32."""
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def phase_wagg_check(dev):
    """wagg_fused against its plain version over x dtype x payload x mask
    x p x N (N = 1000 takes the four-column path; 1, 4097 and 2^20 + 3,
    which are not multiples of 4, the one-column path)."""
    import torch
    from repro_torch.kernels.wagg import wagg_fused, wagg_fused_ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    beta = 0.9
    worst = {}
    n_cases = 0
    for xd in (torch.float32, torch.bfloat16):
        xname = str(xd).split(".")[1]
        for payload in ("none", "bfloat16", "int8"):
            for mask in ("none", "mixed", "one_active"):
                for p in (1, 3, 8, 33):
                    for n in (1, 1000, 4097, 2 ** 20 + 3):
                        x, theta, q, act = wagg_inputs(p, n, xd, payload,
                                                       mask, gen, dev)
                        out = wagg_fused(x, theta, beta, payload=q,
                                         active=act)
                        ref = wagg_fused_ref(x, theta, beta, payload=q,
                                             active=act)
                        torch.cuda.synchronize()
                        name = f"{xname}/{payload}/{mask}/p{p}/n{n}"
                        if not bool(torch.isfinite(out.float()).all()):
                            raise AssertionError(f"wagg {name}: non-finite")
                        if out.shape != x.shape or out.dtype != x.dtype:
                            raise AssertionError(f"wagg {name}: output "
                                                 f"{out.shape} {out.dtype}")
                        rel = rel_err(out, ref)
                        if not rel <= WAGG_TOL[xname]:
                            raise AssertionError(
                                f"wagg {name}: rel_err {rel} > "
                                f"{WAGG_TOL[xname]}")
                        key = f"{xname}/{payload}"
                        worst[key] = max(worst.get(key, 0.0), rel)
                        n_cases += 1
                        del x, q, out, ref
    return {"phase": "wagg_check", "cases": n_cases, "beta": beta,
            "p": [1, 3, 8, 33], "n": [1, 1000, 4097, 2 ** 20 + 3],
            "masks": ["none", "mixed", "one_active"],
            "worst_rel_err": worst, "tol": WAGG_TOL,
            "tol_reason": "rel. to max|plain|; f32: summation order over "
                          "<= 33 rows; bf16 output: one bf16 ulp (2^-8)"}


def wagg_work(p, n, x_bytes, q_bytes):
    """Bytes one unmasked call must move (x and the payload read once,
    theta read, out written once) and its float32 operations (p FMAs per
    column for m, 3 per output element)."""
    return p * n * (2 * x_bytes + q_bytes) + p * 4, 5 * p * n


def phase_wagg_time(dev):
    """wagg_fused at the shapes of the CNN6 round (its 6 worker leaves at
    p=8, one call = one round's aggregation) and at one gemma3-1b MLP leaf
    (p=4, N=1152*6912, f32 x: 127 MB, past the 50 MB L2)."""
    import torch
    from repro_torch.kernels.wagg import wagg_fused, wagg_fused_ref
    from repro_torch.models import init_cnn6
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    beta = 0.9
    p_cnn = TRAIN["p"]
    cnn_n = [v.numel() for _, v in sorted(init_cnn6(0, device=dev).items())]
    shapes = {"cnn6_round": [(p_cnn, n) for n in cnn_n],
              "lm_mlp_leaf": [LM_LEAF]}
    res = {}
    for shape_name, leaves in shapes.items():
        for payload in ("none", "bfloat16", "int8"):
            sets = [wagg_inputs(p, n, torch.float32, payload, "none", gen,
                                dev) for p, n in leaves]

            def kern():
                return [wagg_fused(x, t, beta, payload=q)
                        for x, t, q, _ in sets]

            def plain():
                return [wagg_fused_ref(x, t, beta, payload=q)
                        for x, t, q, _ in sets]

            def library():              # two calls: GEMV, then lerp
                return [torch.lerp(x, (t @ (x if q is None else q.float())
                                       )[None].expand_as(x), beta)
                        for x, t, q, _ in sets]

            reps = 32 if shape_name == "cnn6_round" else 4
            ms = graph_ms([kern], reps)
            plain_ms = graph_ms([plain], reps)
            library_ms = graph_ms([library], reps)
            pairs = list(zip(kern(), plain()))
            abs_err = max((o.float() - r.float()).abs().max().item()
                          for o, r in pairs)
            err = max(rel_err(o, r) for o, r in pairs)
            lib_err = max(rel_err(o, r) for o, r in zip(library(), plain()))
            if not err <= WAGG_TOL["float32"]:
                raise AssertionError(f"wagg_time {shape_name}/{payload}: "
                                     f"rel_err {err}")
            q_bytes = {"none": 0, "bfloat16": 2, "int8": 1}[payload]
            bytes_moved, flops = map(sum, zip(*(wagg_work(p, n, 4, q_bytes)
                                                for p, n in leaves)))
            t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
            t_o = flops / F32_FLOP_PER_S * 1e3
            res[f"{shape_name}/{payload}"] = {
                "leaves": [list(lf) for lf in leaves], "x": "float32",
                "payload": payload, "launches_per_call": len(leaves),
                "bytes": bytes_moved, "flops": flops,
                "max_abs_err": abs_err, "max_rel_err": err,
                "library_max_rel_err": lib_err,
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "library": "two calls: m = theta @ src.float(), then "
                           "torch.lerp(x, m, beta)",
                "bound_ms": max(t_b, t_o),
                "bound_by": "bytes" if t_b >= t_o else "operations"}
            del sets
    return {"phase": "wagg_time",
            "method": "CUDA graph of 32 (CNN6 round) or 4 (LM leaf) calls, "
                      "10 replays, CUDA events; beta 0.9", **res}


def cnn6_setup():
    """The paper's CNN6 task: make_images(seed=0, n=8192), an
    OrderedDataset with order search, the classification loss."""
    from repro_torch.configs import TrainConfig, WASGDConfig
    from repro_torch.data import OrderedDataset, make_images
    from repro_torch.models import classification_loss, cnn6_apply

    def loss_fn(params, batch):
        return classification_loss(cnn6_apply(params, batch["x"]),
                                   batch["y"]), {}

    def tcfg(backend):
        return TrainConfig(learning_rate=TRAIN["lr"], optimizer="sgd",
                           wasgd=WASGDConfig(tau=TRAIN["tau"], beta=0.9,
                                             backend=backend))

    X, y = make_images(0, TRAIN["n_images"])

    def dataset():
        return OrderedDataset({"x": X, "y": y}, TRAIN["p"], TRAIN["tau"],
                              TRAIN["b_local"],
                              n_segments=TRAIN["n_segments"],
                              seed=TRAIN["order_seed"])
    return loss_fn, tcfg, dataset


def phase_train_agree(dev):
    """One CNN6 round from the same params and batch: the tau local steps
    run once (cuDNN's weight gradients are not bitwise reproducible, and
    CNN6 amplifies a last-bit difference across 8 steps), then each spec's
    rule aggregates the same pre-aggregate params and energies."""
    import torch
    from repro_torch.core import get_codec, replicate_workers, shared_axes
    from repro_torch.models import init_cnn6
    from repro_torch.optim import make_optimizer
    from repro_torch.train import (build_train_step, init_comm_state,
                                   init_state, wasgd_rule)
    loss_fn, tcfg, dataset = cnn6_setup()
    p = TRAIN["p"]
    base = init_cnn6(0, device=dev)
    params, axes = replicate_workers(base, shared_axes(base), p)
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in next(dataset().batches()).items()}
    cfg = tcfg("einsum:f32")
    opt = make_optimizer("sgd", TRAIN["lr"])
    seen = {}

    def recording(prm, ax, h, cs, rule=wasgd_rule(cfg.wasgd)):
        seen.update(params=prm, h=h, comm_state=cs)
        return rule(prm, ax, h, cs)

    step = build_train_step(loss_fn, opt, axes, cfg.wasgd, p, rule=recording)
    comm = init_comm_state("wasgd+", params, axes, p, cfg.wasgd)
    state, metrics = step(init_state(params, opt.init(params), p, comm),
                          batch)
    out = {"einsum:f32": state.params}
    for spec in ("pallas_wagg:f32", "pallas_wagg:int8", "einsum:int8"):
        out[spec] = wasgd_rule(tcfg(spec).wasgd)(
            seen["params"], axes, seen["h"], seen["comm_state"])[0]
    torch.cuda.synchronize()
    theta = metrics["theta"]
    checks = []
    for a, b, codec in (("pallas_wagg:f32", "einsum:f32", "f32"),
                        ("pallas_wagg:int8", "einsum:int8", "int8")):
        worst, worst_ratio = 0.0, 0.0
        for k in sorted(out[a]):
            if not bool(torch.isfinite(out[a][k]).all()):
                raise AssertionError(f"train_agree {a}/{k}: non-finite")
            diff = (out[a][k] - out[b][k]).abs().max().item()
            bound = (1e-5 if codec == "f32" else get_codec("int8")
                     .error_bound(seen["params"][k], theta, 0.9).item())
            worst = max(worst, diff)
            worst_ratio = max(worst_ratio, diff / bound)
            if not diff <= bound:
                raise AssertionError(f"train_agree {a} vs {b} leaf {k}: "
                                     f"{diff} > {bound}")
        checks.append({"specs": [a, b], "max_abs_diff": worst,
                       "max_diff_over_bound": worst_ratio,
                       "bound": "1e-5" if codec == "f32" else
                                "int8 error_bound per leaf"})
    int8_vs_f32 = max((out["pallas_wagg:int8"][k] - out["einsum:f32"][k])
                      .abs().max().item() for k in out["einsum:f32"])
    return {"phase": "train_agree", "p": p, "tau": TRAIN["tau"],
            "b_local": TRAIN["b_local"], "theta": theta.tolist(),
            "checks": checks, "int8_vs_f32_max_abs_diff": int8_vs_f32}


def run_trainer(tr, dataset, rounds):
    import torch
    ds = dataset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(ds, rounds)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, ds


def new_trainer(dev):
    from repro_torch.core import shared_axes
    from repro_torch.models import init_cnn6
    from repro_torch.train import Trainer
    loss_fn, tcfg, dataset = cnn6_setup()
    params = init_cnn6(0, device=dev)
    tr = Trainer(loss_fn, params, shared_axes(params),
                 tcfg(TRAIN["backend"]), TRAIN["p"], rule="wasgd+",
                 device=dev)
    return tr, dataset


def phase_train(dev):
    import torch
    from repro_torch.core.order import OrderState
    from repro_torch.kernels.wagg import wagg_fused
    warm, dataset = new_trainer(dev)
    warm_s, _ = run_trainer(warm, dataset, 2)
    del warm
    tr, dataset = new_trainer(dev)
    torch.cuda.reset_peak_memory_stats()
    wagg_fused.launches = 0
    wall, ds = run_trainer(tr, dataset, TRAIN["rounds"])
    launches = wagg_fused.launches
    want = TRAIN["rounds"] * CNN6_LEAVES
    if launches != want:
        raise AssertionError(f"train: {launches} wagg_fused launches, want "
                             f"{TRAIN['rounds']} rounds x {CNN6_LEAVES} "
                             f"worker leaves = {want}")
    losses = tr.losses()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"train: losses {losses}")
    for k, v in tr.state.params.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"train: non-finite params {k}")
    theta = np.stack([h["theta"] for h in tr.history])
    seeds0 = OrderState(TRAIN["p"], TRAIN["n_segments"],
                        TRAIN["order_seed"]).seeds
    return {"phase": "train", "model": "cnn6", **TRAIN,
            "rule": "wasgd+", "launches": launches,
            "seconds_per_round": wall / TRAIN["rounds"], "wall_s": wall,
            "warmup_2_rounds_s": warm_s,
            "samples_per_s": TRAIN["rounds"] * TRAIN["p"] * TRAIN["tau"]
            * TRAIN["b_local"] / wall,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "losses": [float(x) for x in losses],
            "theta_min": float(theta.min()), "theta_max": float(theta.max()),
            "rounds_per_segment": ds.rounds_per_segment,
            "order_decisions": (TRAIN["rounds"] - 1)
            // ds.rounds_per_segment,
            "seeds_reshuffled": int((ds.order.seeds != seeds0).sum()),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_train_profile(dev):
    """A fresh trainer: 2 warm-up rounds, 5 rounds unprofiled (wall), then
    5 under torch.profiler on device activity: busy time against that
    wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    rounds = 5
    tr, dataset = new_trainer(dev)
    run_trainer(tr, dataset, 2)
    wall, _ = run_trainer(tr, dataset, rounds)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_prof, _ = run_trainer(tr, dataset, rounds)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    return {"phase": "train_profile", "rounds": rounds,
            "wall_ms": wall * 1e3, "wall_ms_profiled": wall_prof * 1e3,
            "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / (wall * 1e3)
                                  if busy_ms > 0 else None),
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "device_ms": dev_us(e) / 1e3} for e in top]}


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False; this "
                 "script measures the port on an NVIDIA card only")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attn import paged_decode_attn
    from repro_torch.models import init_params
    from repro_torch.serve import ContinuousEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    t0 = time.perf_counter()
    built = build.build()
    build_s = time.perf_counter() - t0
    emit({"phase": "env", "seconds": build_s, "nvidia_smi": smi,
          "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "build_s": build_s, "nvcc_flags": " ".join(build.NVCC_FLAGS),
          "ptxas": {k: ptxas_summary(v.ptxas) for k, v in built.items()}})

    run_phase(phase_kernel_check, dev)
    timing = run_phase(phase_kernel_time, dev)
    run_phase(phase_wagg_check, dev)
    wagg_timing = run_phase(phase_wagg_time, dev)

    cfg = get_config(ARCH)
    params = init_params(cfg, seed=0, device=dev)          # float32
    run_phase(phase_agree, cfg, params, dev)
    eng = ContinuousEngine(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                           block_size=BLOCK, chunk=CHUNK, device=dev)
    del params                          # the engine keeps its bf16 copy
    torch.cuda.empty_cache()
    serve = run_phase(phase_serve, cfg, eng)
    run_phase(phase_serve_profile, cfg, eng)
    del eng
    torch.cuda.empty_cache()

    run_phase(phase_train_agree, dev)
    train = run_phase(phase_train, dev)
    run_phase(phase_train_profile, dev)

    t = timing["ring512"]
    w = wagg_timing["cnn6_round/none"]
    lm = wagg_timing["lm_mlp_leaf/none"]
    emit({"kernels": [{
        "name": "paged_decode_attn", "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attn/csrc/"
                  "paged_decode_attn.cu",
        "replaces": "src/repro/kernels/decode_attn/paged.py:92",
        "launches": serve["launches"], "max_abs_err": t["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "shape": t["shape"]}, {
        "name": "wagg_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/wagg/csrc/wagg_fused.cu",
        "replaces": "src/repro/kernels/wagg/wagg.py:88",
        "launches": train["launches"], "max_abs_err": w["max_abs_err"],
        "ms": w["ms"], "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
        "bound_by": w["bound_by"], "library_ms": w["library_ms"],
        "library": w["library"], "shape": w["leaves"],
        "note": "one call = one CNN6 round's aggregation (6 launches, "
                "f32 x, no payload); lm_mlp_leaf: p=4 x 1152*6912 f32",
        "lm_mlp_leaf": {k: lm[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}}]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Times the cache hints of ``wagg_fused``'s loads and stores on one card.

    python3 tools/wagg_hints.py

Builds the committed ``kernels/wagg/csrc/wagg_fused.cu`` as it is and in
variants that change only its cache hints, then times each through
``wagg_fused_many`` at ``chip_smoke.py`` ``wagg_time``'s shapes (the CNN6
round as one grouped call; the gemma3-1b MLP leaf, masked too, and with
a bf16 payload; the stablelm-3b int4 leaf), the variants in turns, four
passes, alternating the order. Every variant's output is checked bitwise
against the first's. Beside them, ``Tensor.copy_`` of the gemma3-1b leaf
(the same bytes read and written as the kernel moves there) gives the
card's practical rate. Prints each shape's times, the minimum per
variant, and the card's name and power limit.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

# what each variant puts after the source's includes
VARIANTS = {
    "kernel": "",                                    # ld.global.nc, st.cs
    "cs_loads": "#define __ldg __ldcs\n",             # ld.global.cs
    "plain_stores": "#define __stcs(p, v) (*(p) = (v))\n",
    "cg_stores": "#define __stcs __stcg\n",
}
PASSES = 4


def main():
    import torch
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.wagg import wagg as W
    from repro_torch.models import init_cnn6
    src = build.SOURCES["wagg_fused"].read_text()
    out_dir = os.path.join(ROOT, "chiprun_out", "wagg_hints")
    os.makedirs(out_dir, exist_ok=True)
    for name, extra in VARIANTS.items():
        path = os.path.join(out_dir, f"wagg_{name}.cu")
        with open(path, "w") as f:
            f.write(src.replace("#include <type_traits>\n",
                                "#include <type_traits>\n" + extra, 1))
        build.SOURCES[f"wagg_{name}"] = build.Path(path)
    built = build.build([f"wagg_{n}" for n in VARIANTS])
    fns = {}
    for name in VARIANTS:
        fn = ctypes.CDLL(str(built[f"wagg_{name}"].path)).wagg_fused_launch
        fn.argtypes = W._launch_fn().argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    cnn = [chip_smoke.wagg_inputs(chip_smoke.TRAIN["p"], v.numel(),
                                  torch.float32, "none", "none", gen, dev)
           for _, v in sorted(init_cnn6(0, device=dev).items())]
    cases = {"cnn6_round/none": ([c[0] for c in cnn], cnn[0][1], None, None,
                                 32)}
    for label, (p, n), payload, mask in (
            ("lm_mlp_leaf/none", chip_smoke.LM_LEAF, "none", "none"),
            ("lm_mlp_leaf/none/masked", chip_smoke.LM_LEAF, "none",
             "one_inactive"),
            ("lm_mlp_leaf/bfloat16", chip_smoke.LM_LEAF, "bfloat16", "none"),
            ("lm3b_mlp_leaf/int4", chip_smoke.LM3B_LEAF, "int4", "none")):
        x, t, q, act = chip_smoke.wagg_inputs(p, n, torch.float32, payload,
                                              mask, gen, dev)
        cases[label] = ([x], t, [q], act, 4)
    res, first = {}, {}
    for i in range(PASSES):
        for name in (list(VARIANTS) if i % 2 == 0 else list(VARIANTS)[::-1]):
            W._launch_fn = lambda fn=fns[name]: fn
            for label, (xs, t, qs, act, reps) in cases.items():
                def call(xs=xs, t=t, qs=qs, act=act):
                    return W.wagg_fused_many(xs, t, 0.9, payloads=qs,
                                             active=act)
                outs = call()
                if not all(torch.equal(a, b) for a, b in
                           zip(outs, first.setdefault(label, outs))):
                    raise AssertionError(f"{name} {label}: output differs")
                res.setdefault(label, {}).setdefault(name, []).append(
                    chip_smoke.graph_ms([call], reps))
    # the card's practical rate for the same bytes: one device copy that
    # reads and writes as many bytes as the f32 leaf without a payload
    x = cases["lm_mlp_leaf/none"][0][0]
    dst = torch.empty_like(x)
    res["lm_mlp_leaf/none"]["copy_"] = [
        chip_smoke.graph_ms([lambda: dst.copy_(x)], 4) for _ in range(PASSES)]
    print(json.dumps({"ms": res}))
    for label, r in res.items():
        print(label, json.dumps({n: min(v) for n, v in r.items()}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()

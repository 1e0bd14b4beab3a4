#!/usr/bin/env python3
"""Holds ``wagg_fused`` bitwise to the one-leaf kernel of an older checkout.

    git archive <commit> | tar -x -C _scratch/parent
    python3 tools/wagg_parent_bitwise.py _scratch/parent

The older checkout's ``kernels/wagg/csrc/wagg_fused.cu`` must have the
one-leaf C entry ``wagg_fused_launch(x, q, theta, active, out, x_dtype,
q_dtype, p, n, vec, keep, beta, stream)``. Builds it with this checkout's
flags, then runs both kernels on the same inputs (``chip_smoke.py``'s
``wagg_inputs``) over x dtype x payload x mask x p x N, this checkout's
through ``wagg_fused`` (a group of one), and counts the cases whose
outputs differ in any bit. Exits 1 if any does. Needs one card.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

P = (1, 2, 3, 4, 5, 8, 9, 33)
N = (1, 7, 1000, 4097, 65536, 2 ** 20 + 3)


def main():
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    import torch
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.wagg import wagg_fused
    src = os.path.join(os.path.abspath(sys.argv[1]), "src", "repro_torch",
                       "kernels", "wagg", "csrc", "wagg_fused.cu")
    lib = os.path.join(ROOT, "chiprun_out", "wagg_parent.so")
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True)
    old = ctypes.CDLL(lib).wagg_fused_launch
    old.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                       ctypes.c_float, ctypes.c_void_p])
    old.restype = ctypes.c_int
    code = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

    def older(x, theta, beta, payload=None, active=None):
        p, n = x.shape
        q = x if payload is None else payload
        out = torch.empty_like(x)
        vec = 4 if n % 4 == 0 and all(t.data_ptr() % 16 == 0
                                      for t in (x, q, out)) else 1
        err = old(x.data_ptr(), q.data_ptr(), theta.data_ptr(),
                  None if active is None else active.data_ptr(),
                  out.data_ptr(), code[x.dtype], code[q.dtype], p, n, vec,
                  1.0 - beta, beta, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"older wagg_fused_launch: error {err}")
        return out

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    cases, differ = 0, []
    for xd in (torch.float32, torch.bfloat16):
        for payload in ("none", "bfloat16", "int8", "int4"):
            for mask in ("none", "mixed", "one_active"):
                for p in P:
                    for n in N:
                        x, theta, q, act = chip_smoke.wagg_inputs(
                            p, n, xd, payload, mask, gen, dev)
                        a = wagg_fused(x, theta, 0.9, payload=q, active=act)
                        b = older(x, theta, 0.9, payload=q, active=act)
                        cases += 1
                        if not torch.equal(a, b):
                            differ.append([str(xd), payload, mask, p, n])
    print(json.dumps({"cases": cases, "differ": len(differ),
                      "first_differing": differ[:20], "p": P, "n": N}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    sys.exit(1 if differ else 0)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where B1's time goes: the phases of one ``fused_decode`` launch, per
CTA, on one card.  From the root of a checkout on a machine with a card:

    python3 scripts/b1_phases.py [--out DIR]

Builds ``csrc/fused_decode.cu`` once more with its ``FD_STAMP(i)`` hooks
defined (thread 0 of every CTA records ``%globaltimer`` at the end of
each phase), into ``DIR`` (default ``build/b1_phases``), runs the
library's ``fused_decode_launch`` through the wrapper at the Llama2-7B,
Granite-8B and Minitron-4B shapes of ``chip_smoke.gqa_case`` (its ragged
lengths, and every slot free: no attention over the cache), and prints
one JSON line per case: the launch's span (first stamp to last, µs), and
per phase the median and the largest time a CTA spent in it (µs):

  norm     the first wqkv tiles' issue, the rank's share of the rows, RMSNorm
  proj     the wqkv stream and its tensor-core products
  reduce   the cluster's sum and gather of q|k|v
  attend   RoPE and the attention over the rank's live rows
  merge    the first wo tiles' issue and the flash merge
  new      the new token
  wo       the wo stream and its products

The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

PHASES = ("norm", "proj", "reduce", "attend", "merge", "new", "wo")
MAX_CTAS = 1024

WRAPPER = r'''
#include <cuda_runtime.h>
__device__ unsigned long long fd_stamps[%d * 8];
#define FD_STAMP(i) do { if (threadIdx.x == 0) { unsigned long long t_; \
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t_)); \
    fd_stamps[blockIdx.x * 8 + (i)] = t_; } } while (0)
#include "@KERNEL@"
extern "C" int fd_read_stamps(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, fd_stamps, n * 8 * sizeof(unsigned long long));
}
''' % MAX_CTAS


def build(out: str) -> ctypes.CDLL:
    """The library with the stamps defined."""
    from repro_torch.kernels import _build
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "fd_phases.cu")
    with open(src, "w") as f:
        f.write(WRAPPER.replace("@KERNEL@",
                                str(_build.CSRC / "fused_decode.cu")))
    lib = os.path.join(out, "libfd_phases.so")
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                          str(_build.CSRC), "-o", lib, src],
                         capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(f"nvcc failed:\n{run.stdout[-3000:]}")
    return ctypes.CDLL(os.path.abspath(lib))


def phases(lib, b1, a, kw, cfg) -> dict:
    """One launch's stamps (after four), per phase over the CTAs."""
    import torch
    for _ in range(5):
        b1.fused_decode_cuda(*a.values(), **kw)
    torch.cuda.synchronize()
    C, H = b1.cluster_plan(cfg.n_heads, cfg.n_kv_heads, cfg.d_model)
    ctas = cfg.n_kv_heads * C
    buf = (ctypes.c_ulonglong * (MAX_CTAS * 8))()
    assert lib.fd_read_stamps(buf, MAX_CTAS) == 0
    st = [[buf[c * 8 + i] for i in range(8)] for c in range(ctas)]
    per = {name: [(s[i + 1] - s[i]) / 1e3 for s in st]
           for i, name in enumerate(PHASES)}
    return dict(C=C, H=H, ctas=ctas,
                span_us=round((max(s[7] for s in st)
                               - min(s[0] for s in st)) / 1e3, 2),
                median_us={k: round(statistics.median(v), 2)
                           for k, v in per.items()},
                max_us={k: round(max(v), 2) for k, v in per.items()})


def use(lib, b1):
    """Point the wrapper at ``lib``'s entry."""
    from repro_torch.kernels import _build
    launch = lib.fused_decode_launch
    launch.argtypes = b1._ARGTYPES
    launch.restype = ctypes.c_int
    lib.fd_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    _build.function = lambda name, symbol, argtypes: launch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "b1_phases"))
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("b1_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.fused_decode import fused_decode as b1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps(dict(card=smi.splitlines()[0])), flush=True)
    lib = build(opt.out)
    use(lib, b1)
    for arch in ("llama2-7b", "granite-8b", "minitron-4b"):
        cfg = cs.path_config(arch)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cs.SEED + 1)
        case = cs.gqa_case(cfg, gen)
        args, kw = case["args"], case["kw"]
        free = dict(args, cache_lens=torch.full_like(args["cache_lens"], -1),
                    include_new=torch.zeros_like(args["include_new"]))
        for slots, a in (("ragged", args), ("all free", free)):
            print(json.dumps(dict(path=arch, slots=slots,
                                  **phases(lib, b1, a, kw, cfg))),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Two measurements of the ``beta_err_partials`` CUDA kernel that
``chip_smoke.py`` does not take, on one NVIDIA GPU.

    python3 scripts/beta_err_probe.py      # from the root of a checkout

1. Its block at k <= 16: the kernel built with 512 and with 1024 threads a
   block (``BETA_ERR_THREADS_K16`` of ``csrc/kl_ell.cu``, set in a copy of
   the source under ``build/beta_err_probe/``), each timed (CUDA events,
   median of warmed launches) at the main path's shapes: one 5,000-row chunk
   and the whole 10,000-row matrix of ``chip_smoke.py``'s pipeline data,
   R=20, k in {9, 13}, in the order 512, 1024, 1024, 512. A row's value
   does not depend on the grid, so the two builds must agree bit for bit.
2. The SASS instructions of one stored slot's KL term (``kl_slot_term``):
   a probe kernel that applies it to two arrays, compiled with the source
   included, read with ``cuobjdump -sass`` beside a probe that adds the two
   arrays; and the instructions of each ``beta_err_kernel`` instance of the
   built library.

The last lines are the card's ``nvidia-smi`` name and power limit and one
JSON object with every number. Without a card it exits 2.
"""

from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402
from cnmf_torch_tpu_torch.ops.kernels import kl_ell  # noqa: E402
from cnmf_torch_tpu_torch.ops.sparse import (csr_to_ell,  # noqa: E402
                                             ell_chunk_rows)

OUT = os.path.join(HERE, "build", "beta_err_probe")
BLOCK = re.compile(r"BETA_ERR_THREADS_K16 = \d+;")
# an instruction line of cuobjdump -sass: its offset, a predicate, the opcode
SASS = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")
PROBE = r"""
#include "%s"
extern "C" __global__ void probe_term(const float* v, const float* wh,
                                      float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = kl_slot_term(v[i], wh[i]);
}
extern "C" __global__ void probe_base(const float* v, const float* wh,
                                      float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = v[i] + wh[i];
}
"""


def variant_lib(threads: int):
    """The library built from a copy of the source whose k <= 16 block has
    ``threads`` threads."""
    with open(kl_ell.SOURCE) as f:
        text = f.read()
    if len(BLOCK.findall(text)) != 1:
        raise RuntimeError("BETA_ERR_THREADS_K16 not found once in "
                           f"{kl_ell.SOURCE}")
    path = os.path.join(OUT, f"kl_ell_threads{threads}.cu")
    with open(path, "w") as f:
        f.write(BLOCK.sub(f"BETA_ERR_THREADS_K16 = {threads};", text))
    kl_ell.SOURCE, kl_ell._lib = path, None
    return kl_ell.build(), dict(kl_ell.build_info)


def sass_functions(binary: str) -> dict:
    """Instructions per function of ``cuobjdump -sass``, opcodes counted."""
    tool = os.path.join(os.path.dirname(kl_ell._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", binary], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = collections.Counter()
            continue
        m = SASS.search(line)
        if m and name and m.group(1) != "NOP":
            out[name][m.group(1)] += 1
    return out


def term_instructions(source: str) -> dict:
    probe = os.path.join(OUT, "probe.cu")
    with open(probe, "w") as f:
        f.write(PROBE % source)
    cubin = os.path.join(OUT, "probe.cubin")
    subprocess.run([kl_ell._nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-cubin", "-o", cubin, probe],
                   check=True, capture_output=True, text=True)
    funcs = sass_functions(cubin)
    term, base = funcs["probe_term"], funcs["probe_base"]
    extra = term - base
    return {"term_probe": sum(term.values()), "add_probe": sum(base.values()),
            "term": sum(term.values()) - sum(base.values()),
            "term_opcodes": dict(extra.most_common())}


def main() -> int:
    if not torch.cuda.is_available():
        print("beta_err_probe: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    smi = chip_smoke.nvidia_smi_line()
    source = kl_ell.SOURCE
    libs = {t: variant_lib(t) for t in (512, 1024)}
    kl_ell.SOURCE, kl_ell._lib = source, None
    kl_ell.build()      # the library of the source as it stands
    report = {"card": smi, "instructions": term_instructions(source)}
    report["kernel_instructions"] = {
        name: sum(c.values())
        for name, c in sass_functions(kl_ell.build_info["library"]).items()
        if "beta_err_kernel" in name}

    _, Xn = chip_smoke.prepared_counts(OUT)
    xc, _ = ell_chunk_rows(Xn, chip_smoke.CHUNK)
    shapes = {"chunk": xc.chunk(0).to("cuda"),
              "whole": csr_to_ell(Xn, transpose=False).to("cuda")}
    R = chip_smoke.REPLICATES
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    times = collections.defaultdict(list)
    launch = {}
    for shape, x in shapes.items():
        n, g = x.vals.shape[0], x.g
        for k in (9, 13):
            H = (torch.rand((R, n, k), generator=gen) + 0.1).cuda()
            W = (torch.rand((R, k, g), generator=gen) + 0.1).cuda()
            outs = {}
            for threads in (512, 1024, 1024, 512):
                kl_ell._lib = libs[threads][0]
                fn = lambda: kl_ell.beta_err_partials(  # noqa: E731
                    x.vals, x.cols, H, W)
                outs[threads] = fn()
                times[f"{shape} k={k} {threads}"].append(
                    chip_smoke.cuda_ms(fn, iters=100, warmup=10))
                launch[f"{shape} k={k} {threads}"] = kl_ell.beta_err_launch(
                    R, n, k, g)
            torch.cuda.synchronize()
            chip_smoke.check(torch.equal(outs[512], outs[1024]),
                             f"{shape} k={k}: 512 and 1024 threads differ")
    report["ms"] = dict(times)
    report["launch"] = launch
    for key, ms in times.items():
        print(f"beta_err_partials {key:22s} threads: {ms[0]:.4f} / "
              f"{ms[1]:.4f} ms; launch {launch[key]}")
    ins = report["instructions"]
    print(f"kl_slot_term: {ins['term']} SASS instructions "
          f"({ins['term_probe']} in the probe, {ins['add_probe']} in the add "
          f"probe): {ins['term_opcodes']}")
    for name, count in report["kernel_instructions"].items():
        print(f"{name}: {count} SASS instructions")
    for threads, (_, info) in libs.items():
        for line in chip_smoke.ptxas_summary(info["log"]):
            if "beta_err" in line:
                print(f"{threads}-thread build:{line}")
    print(smi)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Ablation of the fast den's one-plane scans (csrc/den_scan.cu at pre = 2,
csrc/den_mma.cuh `plane_product_block`): what each part of the design buys.

Usage:
    python -m kaldi_fp16_tpu_torch.tools.ablate_den_scan [--rounds 2]
        [--variants base,no_pdl,...] [--batch 128] [--frames 49] [--pdfs 3080]

Builds den_scan.cu from copies of the sources with one change each and
runs the one-plane forward and backward scans at the production den
(the 7052-state phone-LM graph: L = 2, Fp = 3584, N = --batch, T =
--frames), each variant in turns with the unchanged copy (base, variant,
variant, base; --rounds times):

  base          the sources as they are
  no_pdl        the frame's launches without programmatic dependent launch
  stages4       a ring of 4 stages (8 in the sources)
  stages12      a ring of 12 stages
  two_partials  two partial register sets: stage i + 1's wgmma runs while
                stage i is added into the total (same order, same bits)
  l2_hints      an L2 evict_last policy on the plane's bulk copies, and
                the update's emissions and history loaded and stored .cs
                (evict-first)
  no_loads      no bulk copies into shared memory (stale data: time only)
  no_wgmma      no tensor-core products (time only)

and the standing three-plane terms = 1 route (split="kernel", the repo's
build) in turns with base.  One JSON line per variant: ms per scan of it
and of base in the same turns, whether its outputs equal base's bit for
bit (the exact variants must), each frame kernel's mean device us
(torch.profiler; under PDL a kernel's time includes its wait for the one
before it) and ptxas' registers and spills of its product and update
kernels.  The first line is the card's name and power limit.  Needs a
card and nvcc; builds under build/kaldi_fp16_tpu_torch/ablate_scan/.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from kaldi_fp16_tpu_torch.ops import _build, den_scan

# (file, text, replacement) of each variant; every text must occur once
WAIT = "    mbar_wait(bars + it % STAGES1, (it / STAGES1) & 1);\n"
PROLOGUE = "    for (int i = 0; i < STAGES1 && i < nk; ++i) load(i);"
REFILL = "      load(it + STAGES1);"
WGMMA = "      wgmma_128(part, a[j],\n"
COPY_A = "    bulk_copy(st, A + (size_t)i * TILE1, TILE1, bar);\n"
COPY_A_KEEP = """    {
      uint64_t keep;
      asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\\n"
                   : "=l"(keep));
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          ".L2::cache_hint [%0], [%1], %2, [%3], %4;\\n"
          :: "r"(smem_addr(st)), "l"(A + (size_t)i * TILE1),
             "r"((uint32_t)TILE1), "r"(smem_addr(bar)), "l"(keep)
          : "memory");
    }
"""
FWD_UPDATE = """      hist[o] = ad;
      float u = ad * xs_self[o];
      if (l >= 1) u += prev * xs_fwd[o - FN];
      if (l == 0) u += f * xs_res[rc];"""
FWD_UPDATE_CS = """      __stcs(hist + o, ad);
      float u = ad * __ldcs(xs_self + o);
      if (l >= 1) u += prev * __ldcs(xs_fwd + o - FN);
      if (l == 0) u += f * __ldcs(xs_res + rc);"""
BWD_UPDATE = """      hist[o] = bn;
      float b = bn * xs_self[o];
      if (l < L - 1) b += next * xs_fwd[o];"""
BWD_UPDATE_CS = """      __stcs(hist + o, bn);
      float b = bn * __ldcs(xs_self + o);
      if (l < L - 1) b += next * __ldcs(xs_fwd + o);"""
LOOP_START = "  for (int it = 0; it < nk; ++it) {\n" + WAIT
LOOP_END = "  store_partial(op, acc);\n}\n"
TWO_PARTIALS = """  auto issue = [&](int it, float (&p)[64], uint32_t (&a)[2][4]) {
""" + WAIT + """    const char* st = smem + (it % STAGES1) * 2 * TILE1;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      ldmatrix_x4(a[j], st + a_off + j * 2 * PLANE_KB * 2, false);
    asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wgmma_128(p, a[j],
                smem_desc(st + TILE1 + j * 2 * PLANE_KB * 2, B1_K_STRIDE), j);
    asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
  };
  auto retire = [&](int it, float (&p)[64], uint32_t (&a)[2][4]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_reg(p[i]);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) fence_reg(a[j][q]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += p[i];
    __syncthreads();
    if (threadIdx.x == 0 && it + STAGES1 < nk) {
      asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
      load(it + STAGES1);
    }
  };
  float part1[64];
  uint32_t a0[2][4], a1[2][4];
  if (nk > 0) issue(0, part, a0);
  for (int it = 0; it < nk; it += 2) {
    if (it + 1 < nk) {
      issue(it + 1, part1, a1);
      asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");
    } else {
      asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
    }
    retire(it, part, a0);
    if (it + 1 < nk) {
      if (it + 2 < nk) {
        issue(it + 2, part, a0);
        asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");
      } else {
        asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
      }
      retire(it + 1, part1, a1);
    }
  }
""" + LOOP_END
STAGES = "constexpr int STAGES1 = 8; "
MMA, SCAN = "den_mma.cuh", "den_scan.cu"
VARIANTS = {
    "base": [],
    "no_pdl": [(SCAN, "launch(r.one, ", "launch(false, ", 6)],
    "stages4": [(MMA, STAGES, "constexpr int STAGES1 = 4; ", 1)],
    "stages12": [(MMA, STAGES, "constexpr int STAGES1 = 12; ", 1)],
    "two_partials": [(MMA, "loop", TWO_PARTIALS, 1)],
    "l2_hints": [(MMA, COPY_A, COPY_A_KEEP, 1),
                 (SCAN, FWD_UPDATE, FWD_UPDATE_CS, 1),
                 (SCAN, BWD_UPDATE, BWD_UPDATE_CS, 1)],
    "no_loads": [(MMA, WAIT, "", 1), (MMA, PROLOGUE, "    ;", 1),
                 (MMA, REFILL, "      ;", 1)],
    "no_wgmma": [(MMA, WGMMA, "      if (nk < 0) wgmma_128(part, a[j],\n",
                  1)],
}
EXACT = ("base", "no_pdl", "stages4", "stages12", "two_partials", "l2_hints")


def variant_sources(name: str) -> dict:
    """{file name: text} of den_mma.cuh and den_scan.cu for a variant;
    raises if the sources no longer hold a text the variant changes."""
    texts = {f: (_build.CSRC / f).read_text() for f in (MMA, SCAN)}
    for f, old, new, count in VARIANTS[name]:
        t = texts[f]
        if old == "loop":                       # the plane block's stage loop
            start = t.index(LOOP_START)
            end = t.index(LOOP_END, start) + len(LOOP_END)
            texts[f] = t[:start] + new + t[end:]
            continue
        if t.count(old) != count:
            raise RuntimeError(f"{name}: {f} holds {t.count(old)} copies of "
                               f"{old!r}, expected {count}")
        texts[f] = t.replace(old, new)
    return texts


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--frames", type=int, default=49)
    ap.add_argument("--pdfs", type=int, default=3080)
    return ap.parse_args(argv)


def build_variants(names, out_root: Path):
    """{variant: (ctypes library, ptxas lines)}, all compiled at once."""
    nvcc = _build._nvcc()
    procs = {}
    for name in names:
        d = out_root / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        for f, text in variant_sources(name).items():
            (d / f).write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               str(d / SCAN)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{log[-3000:]}")
        lines = log.splitlines()
        ptxas = [f"{lines[k - 2].split('_kernel')[0][-20:]}: "
                 f"{lines[k - 1].split(',', 1)[-1].strip()}; {ln.strip()[14:]}"
                 for k, ln in enumerate(lines)
                 if "Used" in ln and k >= 2
                 and ("plane_product" in lines[k - 2]
                      or "update_kernelILb1E" in lines[k - 2])]
        lib = ctypes.CDLL(str(out_root / name / "lib.so"))
        lib.den_scan_forward.argtypes = [p, i] + [p] * 12 + [i] * 6 + [f, p]
        lib.den_scan_forward.restype = i
        lib.den_scan_backward.argtypes = [p, i] + [p] * 13 + [i] * 6 + [f, p]
        lib.den_scan_backward.restype = i
        libs[name] = (lib, ptxas)
    return libs


def ms(fn):
    """Device ms of one call (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def in_turns(base, other, rounds):
    """(other's mean ms, base's mean ms) over rounds of base, other,
    other, base, after one warm-up call of each."""
    base(), other()
    times = {"base": [], "other": []}
    for _ in range(rounds):
        for tag in ("base", "other", "other", "base"):
            times[tag].append(ms(other if tag == "other" else base))
    return float(np.mean(times["other"])), float(np.mean(times["base"]))


def kernel_us(fn):
    """Mean device us per launch of the frame kernels of one call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as pr:
        fn()
        torch.cuda.synchronize()
    return {k: e.device_time_total / e.count for e in pr.key_averages()
            for k in ("operand", "product", "update")
            if k in e.key and e.device_time_total}


def main(argv=None):
    args = parse_args(argv)
    names = args.variants.split(",")
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"ablate_den_scan: unknown variants {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("ablate_den_scan: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    from kaldi_fp16_tpu_torch.chain.den_layout import analyze_chain_structure
    from kaldi_fp16_tpu_torch.chain.den_structured import StructuredKernels
    from kaldi_fp16_tpu_torch.chain.graph import (
        DenominatorGraph, make_phone_lm_den_fst,
    )
    dev = torch.device("cuda", torch.cuda.current_device())
    libs = build_variants(["base"] + [n for n in names if n != "base"],
                          _build.BUILD_ROOT / "ablate_scan")
    graph = DenominatorGraph.from_fst(make_phone_lm_den_fst(
        num_pdfs=args.pdfs), args.pdfs)
    sk = StructuredKernels(analyze_chain_structure(graph), 1e-5,
                           scan_impl="fused", device=dev)
    L, Fp, N, T = sk.lay.L, sk.lay.F, args.batch, args.frames
    gen = torch.Generator(device=dev).manual_seed(4)
    xs = sk._hoisted_emissions(torch.exp(torch.randn(
        (T, args.pdfs, N), generator=gen, device=dev)))
    plane = den_scan.ScanPlane(sk.M.to(torch.bfloat16))
    kw = dict(L=L, T=T, leaky=sk.leaky, terms=1)
    fwd_ref = den_scan.fused_forward(sk.M, *xs, sk.init, plane=plane, **kw)
    total = fwd_ref[3] * (1.0 + sk.leaky * sk._init_sum)
    real = sk.real.to(torch.float32).contiguous()
    state, parts, panels, ws, S = den_scan._workspace(L, Fp, N, dev, 2)
    stream = torch.cuda.current_stream(dev).cuda_stream
    f32 = dict(dtype=torch.float32, device=dev)

    def scans(lib):
        """(forward call, backward call, their outputs) of a library."""
        hist_f, hist_b = torch.empty((T, L, Fp, N), **f32), \
            torch.empty((T, L, Fp, N), **f32)
        asum, logc = torch.empty((T, N), **f32), torch.empty((T, N), **f32)
        a_final, tot = torch.empty(N, **f32), torch.empty(N, **f32)
        ptr = [t.data_ptr() for t in xs]

        def fwd():
            err = lib.den_scan_forward(
                plane.fwd.data_ptr(), 2, *ptr, sk.init.data_ptr(),
                state.data_ptr(), parts.data_ptr(), panels.data_ptr(),
                ws.data_ptr(), hist_f.data_ptr(), asum.data_ptr(),
                logc.data_ptr(), a_final.data_ptr(), L, Fp, N, T, S, 1,
                sk.leaky, stream)
            if err:
                raise RuntimeError(f"den_scan_forward: cudaError_t {err}")

        def bwd():
            err = lib.den_scan_backward(
                plane.bwd.data_ptr(), 2, *ptr, fwd_ref[1].data_ptr(),
                sk.init.data_ptr(), real.data_ptr(), total.data_ptr(),
                state.data_ptr(), parts.data_ptr(), panels.data_ptr(),
                ws.data_ptr(), tot.data_ptr(), hist_b.data_ptr(), L, Fp, N,
                T, S, 1, sk.leaky, stream)
            if err:
                raise RuntimeError(f"den_scan_backward: cudaError_t {err}")

        return fwd, bwd, (hist_f, asum, logc, a_final, hist_b)

    base_fwd, base_bwd, base_out = scans(libs["base"][0])
    base_fwd(), base_bwd()
    torch.cuda.synchronize()
    rows = []
    for name in names:
        lib, ptxas = libs[name]
        fwd, bwd, out = scans(lib)
        fwd(), bwd()
        torch.cuda.synchronize()
        row = {"variant": name, "exact": name in EXACT,
               "bit_equal_to_base": all(torch.equal(a, b)
                                        for a, b in zip(out, base_out)),
               "ptxas": ptxas}
        for tag, call, base in (("fwd", fwd, base_fwd), ("bwd", bwd,
                                                         base_bwd)):
            row[f"{tag}_ms"], row[f"{tag}_base_ms"] = in_turns(
                base, call, args.rounds)
            row[f"{tag}_kernel_us"] = kernel_us(call)
        if name in EXACT and not row["bit_equal_to_base"]:
            row["failed"] = "an exact variant's outputs differ from base's"
        rows.append(row)
        print(json.dumps(row), flush=True)

    def standing(direction):
        if direction == "fwd":
            return lambda: den_scan.fused_forward(sk.M, *xs, sk.init, **kw)
        return lambda: den_scan.fused_backward(sk.M, *xs, fwd_ref[1],
                                               sk.init, sk.real, total, **kw)

    row = {"variant": "three_plane_kernel_route"}
    for tag, base in (("fwd", base_fwd), ("bwd", base_bwd)):
        row[f"{tag}_ms"], row[f"{tag}_base_ms"] = in_turns(
            base, standing(tag), args.rounds)
        row[f"{tag}_kernel_us"] = kernel_us(standing(tag))
    print(json.dumps(row), flush=True)
    failed = [r["variant"] for r in rows if "failed" in r]
    if failed:
        print(f"FAIL: {failed} differ from base", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

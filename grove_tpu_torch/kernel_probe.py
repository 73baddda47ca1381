"""Where the two commit kernels spend their time, on the card.

Usage: python -m grove_tpu_torch.kernel_probe [--old-k2 PATH]

At the stress shape (5000 nodes, 1000 gangs: G = 1024, D = 5334, K = 8,
chunk 32), builds copies of csrc/commit_topk.cu and csrc/commit_scan.cu
with clock64 stamps patched in, runs each once, and prints its phases in
SM cycles per chunk (commit top-k: thread 0 of block 0, with block
barriers added between phases) or per gang step (device commit: the
walker's lane 0), beside the unpatched kernel's time by CUDA events (L2
flushed before each launch, median of 21). Every copy's result is checked
against the kernel's plain version on the CPU.

With --old-k2, a commit_topk.cu whose kernel takes pre-jittered values
(PR 2's, e.g. `git show 1abc9b5:grove_tpu_torch/csrc/commit_topk.cu`),
also times that kernel and its variants built with macros: K = 1, no
commit, no masking load from device memory, neither, and the grid barrier
alone. Their differences split its time a chunk.

Needs one CUDA card and nvcc; builds into build/grove_tpu_torch/probe/.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys

import torch

from .build import BUILD_DIR, NVCC_FLAGS, PACKAGE_DIR, _nvcc

PROBE_DIR = BUILD_DIR / "probe"
REPS = 21

_PROBE_DECL = """
#include <cuda_runtime.h>
__device__ unsigned long long g_probe[16];
extern "C" int grove_probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
}
#define PT(x) unsigned long long x = clock64()
"""

TOPK_PHASES = ("mask + per-thread top-K", "warp merge", "barrier wait",
               "rank merge", "prefetch start", "grid barrier",
               "commit + barrier", "next demand + copy wait + barrier")
SCAN_PHASES = ("walker: wait for full tiles", "walker: test + ballot",
               "walker: chain, outputs, decrement", "filler 0: wait for empty slots",
               "filler 0: fill")


def _patch(src: str, pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise ValueError(f"probe patch point not found once: {old[:60]!r}")
        src = src.replace(old, new)
    return _PROBE_DECL + src


def probe_topk(src: str) -> str:
    """commit_topk.cu with per-phase stamps by thread 0 of block 0."""
    return _patch(src, [
        ("  for (int start = 0; start < G; start += C) {\n",
         "  unsigned long long ph[8] = {0};\n"
         "  for (int start = 0; start < G; start += C) {\n"
         "    PT(p0);\n    unsigned long long pm = p0;\n"),
        ("      // warp merge: K rounds of a warp max; the owner pops its head\n",
         "      __syncwarp();\n      pm = clock64();\n"),
        ("    __syncthreads();  // warp lists written; every read of `row` done\n",
         "    PT(p1);\n    __syncthreads();\n    PT(p2);\n"),
        ("    // the next chunk's row does not depend on the residual: start its copy\n",
         "    PT(p3);\n"),
        ("    grid.sync();  // the chunk's picks are in global memory\n",
         "    PT(p4);\n    grid.sync();\n    PT(p5);\n"),
        ("    if (has_next) {\n      for (int r = threadIdx.x; r < R;",
         "    __syncthreads();\n    PT(p6);\n"
         "    if (has_next) {\n      for (int r = threadIdx.x; r < R;"),
        ("    __syncthreads();  // residual committed, next row and its demand landed\n  }\n",
         "    __syncthreads();\n    PT(p7);\n"
         "    ph[0] += pm - p0; ph[1] += p1 - pm; ph[2] += p2 - p1; ph[3] += p3 - p2;\n"
         "    ph[4] += p4 - p3; ph[5] += p5 - p4; ph[6] += p6 - p5; ph[7] += p7 - p6;\n"
         "  }\n  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
         "    for (int q = 0; q < 8; ++q) g_probe[q] = ph[q];\n  }\n"),
    ])


def probe_scan(src: str) -> str:
    """commit_scan.cu with stamps by the walker's lane 0 (waits for full
    tiles; a step's test and ballot; its chain, outputs and decrement)
    and by the first filler (waits for empty slots; filling)."""
    return _patch(src, [
        ("  const int lane = threadIdx.x;\n",
         "  const int lane = threadIdx.x;\n  unsigned long long ph[3] = {0};\n"),
        ("    named_sync(full_bar(s));  // the fillers have staged tile t\n",
         "    PT(a0);\n    named_sync(full_bar(s));\n    ph[0] += clock64() - a0;\n"),
        ("    for (int i = 0; i < n; ++i) {\n      bool fits = false;\n",
         "    for (int i = 0; i < n; ++i) {\n      PT(a1);\n      bool fits = false;\n"),
        ("      const float chosen = __shfl_sync(kFull, v, k);\n",
         "      const float chosen = __shfl_sync(kFull, v, k);\n"
         "      PT(a2);\n      ph[1] += a2 - a1;\n"),
        ("      __syncwarp();\n    }\n",
         "      __syncwarp();\n      ph[2] += clock64() - a2;\n    }\n"),
        ("    if (t + kSlots < tiles) named_arrive(empty_bar(s));  // refill this slot\n  }\n}\n",
         "    if (t + kSlots < tiles) named_arrive(empty_bar(s));  // refill this slot\n  }\n"
         "  if (lane == 0) for (int q = 0; q < 3; ++q) g_probe[q] = ph[q];\n}\n"),
        ("    const int f = threadIdx.x - 32;\n",
         "    const int f = threadIdx.x - 32;\n    unsigned long long fw = 0, ff = 0;\n"),
        ("      if (t >= kSlots) named_sync(empty_bar(s));  // the walker is done with it\n",
         "      PT(b0);\n      if (t >= kSlots) named_sync(empty_bar(s));\n"
         "      PT(b1);\n      fw += b1 - b0;\n"),
        ("      named_arrive(full_bar(s));\n    }\n    return;\n",
         "      ff += clock64() - b1;\n      named_arrive(full_bar(s));\n    }\n"
         "    if (f == 0) {\n      g_probe[3] = fw;\n      g_probe[4] = ff;\n    }\n    return;\n"),
    ])


#: PR 2's commit_topk.cu: macro hooks for the step-0 variants
_OLD_K2_HOOKS = [
    ("row[d] = fits ? value[static_cast<size_t>(g) * D + d] : kNeg;",
     "\n#ifdef NO_LOAD\n        row[d] = fits ? 0.001f * d : kNeg;\n#else\n"
     "        row[d] = fits ? value[static_cast<size_t>(g) * D + d] : kNeg;\n#endif\n"),
    ("    if (static_cast<int>(blockIdx.x) < rows) {\n      const int g",
     "#ifdef SYNC_ONLY\n    if (false) {\n#else\n"
     "    if (static_cast<int>(blockIdx.x) < rows) {\n#endif\n      const int g"),
    ("    const int entries = rows * L1;",
     "#if defined(NO_COMMIT) || defined(SYNC_ONLY)\n    continue;\n#endif\n"
     "    const int entries = rows * L1;"),
]
_OLD_K2_VARIANTS = {
    "base": [], "no_commit": ["-DNO_COMMIT"], "no_load": ["-DNO_LOAD"],
    "no_commit_no_load": ["-DNO_COMMIT", "-DNO_LOAD"], "sync_only": ["-DSYNC_ONLY"],
}


def _build(sources: dict[str, tuple[str, list[str]]]) -> dict[str, ctypes.CDLL]:
    """{name: (source text, extra nvcc flags)} -> loaded libraries, one
    nvcc per source, all started together."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, flags) in sources.items():
        cu = PROBE_DIR / f"{name}.cu"
        cu.write_text(text)
        out = PROBE_DIR / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(out), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def _median_ms(fn, flush) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _phases(lib, names, per: int) -> None:
    buf = (ctypes.c_ulonglong * 16)()
    lib.grove_probe_read.argtypes = [ctypes.c_void_p]
    if lib.grove_probe_read(ctypes.addressof(buf)) != 0:
        raise RuntimeError("reading the probe stamps failed")
    for q, name in enumerate(names):
        print(f"    {name:36s} {buf[q] / per:10.1f} cycles")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old-k2", help="PR 2's commit_topk.cu, for step 0")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_probe: CUDA is not available", file=sys.stderr)
        return 2
    from . import stress
    from .solver import PlacementEngine
    from .solver import kernel_core as kc

    topk_src = (PACKAGE_DIR / "csrc/commit_topk.cu").read_text()
    scan_src = (PACKAGE_DIR / "csrc/commit_scan.cu").read_text()
    sources = {"topk": (topk_src, []), "topk_probe": (probe_topk(topk_src), []),
               "scan": (scan_src, []), "scan_probe": (probe_scan(scan_src), [])}
    if args.old_k2:
        old = open(args.old_k2).read()
        for hook, new in _OLD_K2_HOOKS:
            if old.count(hook) != 1:
                raise ValueError(f"--old-k2: hook not found once: {hook[:50]!r}")
            old = old.replace(hook, new)
        for name, flags in _OLD_K2_VARIANTS.items():
            sources[f"old_{name}"] = (old, flags)
    libs = _build(sources)

    dev = torch.device("cuda")
    engine = PlacementEngine(stress.make_cluster(5000))
    value, dom_free, anc, td = engine.score_values(stress.make_gangs(1000))
    g, d = value.shape
    r, l1 = dom_free.shape[1], anc.shape[1]
    k, chunk = 8, 32
    cpu = [t.cpu() for t in (value, dom_free, anc, td)]
    ref_topk = kc.commit_topk_plain(*cpu, k, chunk)
    top_val, top_dom = (t.to(dev) for t in ref_topk)
    ref_scan = kc.device_commit_scan_plain(*ref_topk, *cpu[1:3], cpu[3])
    flush = torch.empty(50 * 2**20, dtype=torch.float32, device=dev)  # 4x L2
    stream = torch.cuda.current_stream().cuda_stream
    f32, i32 = torch.float32, torch.int32
    jittered = torch.where(value > -5e8, value + kc.tie_jitter(g, d, dev), value)

    def topk_call(lib, src_value, kk):
        out = (torch.empty((g, kk), dtype=f32, device=dev),
               torch.empty((g, kk), dtype=i32, device=dev))
        fn = lib.grove_commit_topk
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        ptrs = [src_value.data_ptr(), dom_free.data_ptr(), anc.data_ptr(),
                td.data_ptr(), out[0].data_ptr(), out[1].data_ptr()]

        def call():
            if fn(*ptrs, g, d, r, l1, kk, chunk, stream) != 0:
                raise RuntimeError("commit top-k launch failed")
        return call, out

    def scan_call(lib):
        out = (torch.empty((g, 1), dtype=f32, device=dev),
               torch.empty((g, 1), dtype=i32, device=dev))
        fn = lib.grove_commit_scan
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        ptrs = [top_val.data_ptr(), top_dom.data_ptr(), dom_free.data_ptr(),
                anc.data_ptr(), td.data_ptr(), out[0].data_ptr(), out[1].data_ptr()]

        def call():
            if fn(*ptrs, g, k, d, r, l1, stream) != 0:
                raise RuntimeError("commit-scan launch failed")
        return call, out

    def equal(out, ref) -> bool:
        return all(torch.equal(o.cpu(), rf) for o, rf in zip(out, ref))

    chunks = -(-g // chunk)
    print(f"commit top-k G={g} D={d} K={k} chunk={chunk}, {chunks} chunks")
    for name in ("topk", "topk_probe"):
        call, out = topk_call(libs[name], value, k)
        ms = _median_ms(call, flush)
        print(f"  {name}: {ms:.6f} ms, {ms / chunks * 1e3:.3f} us a chunk, "
              f"== plain: {equal(out, ref_topk)}")
    _phases(libs["topk_probe"], TOPK_PHASES, chunks)
    print(f"device commit G={g} K={k}, {g} gang steps")
    for name in ("scan", "scan_probe"):
        call, out = scan_call(libs[name])
        ms = _median_ms(call, flush)
        print(f"  {name}: {ms:.6f} ms, {ms / g * 1e3:.4f} us a step, "
              f"== plain: {equal(out, ref_scan)}")
    _phases(libs["scan_probe"], SCAN_PHASES, g)
    if args.old_k2:
        print("old commit top-k (pre-jittered values), variants")
        for name in _OLD_K2_VARIANTS:
            for kk in (8, 1):
                call, out = topk_call(libs[f"old_{name}"], jittered, kk)
                ms = _median_ms(call, flush)
                print(f"  {name:18s} K={kk}: {ms:.6f} ms, "
                      f"{ms / chunks * 1e3:.3f} us a chunk")
    return 0


if __name__ == "__main__":
    sys.exit(main())

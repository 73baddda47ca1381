"""Where the value kernel and the two commit kernels spend their time, on the card.

Usage: python -m grove_tpu_torch.kernel_probe [--old-k1 PATH] [--old-k2 PATH]

Value kernel (K1), on the stress solve's own operands (5000 nodes, 1000
gangs: G = 1024, D = 5334, U = 4, S = 1, R = 3, T = 2 demand rows), by
CUDA events with L2 flushed before each launch, median of 21, each result
checked against the fused twin on the CPU: the fused kernel
(csrc/value_kernel.cu) in fp32 and bf16 as it ships; a `fill_` of the
same output; the commit top-k kernel (K2) alone, K2 right after K1 with
its value tensor still in L2, and K1 then K2 back to back with one flush
before the pair; K1's clock-stamped phases; and its variants (K1_VARIANTS:
no demand table, fixed row tiles, 1 or 4 domains a thread, ...). With --old-k1, a value_kernel.cu that takes a gathered
cnt_fit (the design before the fused one, e.g.
`git show e6da2f4:grove_tpu_torch/csrc/value_kernel.cu`) is built as it
is and timed the way the engine ran it: the signature gather and min
(`sig_cnt[sig_idx].amin(1)`, torch), the old kernel, and both. The SASS
of the fused kernel's instances (cuobjdump) goes to
build/grove_tpu_torch/probe/value_kernel.sass, with each instance's
instruction counts printed.

Commit kernels, at the stress shape (5000 nodes, 1000 gangs: G = 1024, D = 5334, K = 8,
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
import collections
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from .build import (BUILD_DIR, NVCC_FLAGS, PACKAGE_DIR, _kernel_name, _nvcc,
                    library_path, load, ptxas_lines)

PROBE_DIR = BUILD_DIR / "probe"
REPS = 21
#: SM cycles the card spins before each timed launch (~0.5 ms)
SPIN_CYCLES = 1_000_000

_PROBE_DECL = """
#include <cuda_runtime.h>
__device__ unsigned long long g_probe[16];
extern "C" int grove_probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
}
extern "C" int grove_probe_reset() {
  unsigned long long init[16] = {0};
  init[8] = ~0ull;  // the earliest entry, by atomicMin
  return (int)cudaMemcpyToSymbol(g_probe, init, sizeof(init));
}
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PT(x) unsigned long long x = clock64()
"""

VALUE_PHASES = ("prologue: a thread's operands into registers",
                "row staging, barrier", "table chains at first use",
                "rows: tests, value terms, stores")
TOPK_PHASES = ("mask + per-thread top-K", "warp merge", "barrier wait",
               "rank merge", "prefetch start", "grid barrier",
               "commit + barrier", "next demand + copy wait + barrier")
SCAN_PHASES = ("walker: wait for full tiles", "walker: test + ballot",
               "walker: chain, outputs, decrement", "filler 0: wait for empty slots",
               "filler 0: fill")


def _replace_once(src: str, pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise ValueError(f"probe patch point not found once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def _patch(src: str, pairs) -> str:
    return _PROBE_DECL + _replace_once(src, pairs)


#: value-kernel variants, built from patched copies of csrc/value_kernel.cu:
#: without the demand table (every live row computes its own score chain,
#: as when more than 8 demand rows differ), fixed tiles of gang rows a
#: block instead of the launcher's one-wave sizing, the domains a thread
#: owns, every division through the IEEE sequence (no zero-numerator
#: shortcut; bit-equal), and diagnostics whose result differs and that are
#: timed only -- the divisions as __fdividef (a reciprocal: no FCHK, no
#: slow-path branch) and no per-row score (mask, select and store)
K1_VARIANTS = {
    "vec2": {}, "notable": {"table": False},
    "rows4": {"rows": 4}, "rows8": {"rows": 8}, "rows16": {"rows": 16},
    "rows32": {"rows": 32},
    "vec4": {"vec": 4}, "vec1": {"vec": 1},
    "notable_fastdiv": {"table": False, "fast_div": True},
    "nozerodiv": {"zero_div": False},
    "notable_nozerodiv": {"table": False, "zero_div": False},
    "noscore": {"no_score": True},
}


def k1_variant(src: str, vec: int = 2, table: bool = True, rows: int = 0,
               fast_div: bool = False, zero_div: bool = True,
               no_score: bool = False) -> str:
    """csrc/value_kernel.cu with the K1_VARIANTS changes applied."""
    pairs = []
    if not table:
        pairs.append(("constexpr int kMaxTable = 8;", "constexpr int kMaxTable = 0;"))
    if rows:
        pairs.append(("  int rows = static_cast<int>((pairs + slots - 1) / slots);\n",
                      f"  int rows = {rows};\n  (void)pairs;\n"))
    if vec != 2:
        pairs.append(("constexpr int kVec = 2;", f"constexpr int kVec = {vec};"))
    if fast_div:
        pairs.append(("  return a / b;\n", "  return __fdividef(a, b);\n"))
    if not zero_div:
        pairs.append(("  if (a == 0.0f && isfinite(b) && b != 0.0f) {\n",
                      "  if (false) {\n"))
    if no_score:
        pairs.append(("        if (any) {\n", "        if (false && any) {\n"))
    return _replace_once(src, pairs)


def probe_value(src: str) -> str:
    """value_kernel.cu with stamps by thread 0 of block (0, 0) between its
    phases, and the grid's first entry and last exit (globaltimer, ns, by
    thread 0 of every block)."""
    return _patch(src, [
        ("  const int d0 = (blockIdx.x * kThreads + threadIdx.x) * kVec;\n",
         "  const int d0 = (blockIdx.x * kThreads + threadIdx.x) * kVec;\n"
         "  PT(p0);\n"
         "  const bool stamp = blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0;\n"
         "  if (threadIdx.x == 0) atomicMin(&g_probe[8], globaltimer());\n"),
        ("  const int tiles = (G + rows - 1) / rows;\n  for (int tile",
         "  PT(p1);\n  const int tiles = (G + rows - 1) / rows;\n  for (int tile"),
        ("    __syncthreads();\n    if (d0 >= D) continue;\n",
         "    __syncthreads();\n    PT(p2);\n    if (d0 >= D) continue;\n"),
        ("    float* dst = out + static_cast<size_t>(g0) * D + d0;\n",
         "    PT(p3);\n    float* dst = out + static_cast<size_t>(g0) * D + d0;\n"),
        ("      store(dst, v, left);\n    }\n",
         "      store(dst, v, left);\n    }\n    PT(p4);\n"
         "    if (stamp) {\n      g_probe[0] = p1 - p0;\n      g_probe[1] = p2 - p1;\n"
         "      g_probe[2] = p3 - p2;\n      g_probe[3] = p4 - p3;\n    }\n"
         "    if (threadIdx.x == 0) atomicMax(&g_probe[9], globaltimer());\n"),
    ])


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


def _build(sources: dict[str, tuple[str, list[str]]],
           logs: dict | None = None) -> dict[str, ctypes.CDLL]:
    """{name: (source text, extra nvcc flags)} -> loaded libraries, one
    nvcc per source, all started together (compiler output into `logs`)."""
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
        if logs is not None:
            logs[name] = log
        libs[name] = ctypes.CDLL(str(out))
    return libs


def _median_ms(fn, flush, read_flush: bool = False) -> float:
    """CUDA-event time of single launches, median of REPS, with L2 flushed
    before each: by writing the flush buffer (L2 left full of dirty lines)
    or, with read_flush, by reading it (L2 left full of clean lines). The
    card then spins ~0.5 ms, so the launch's host side is queued before
    the start event fires."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        if read_flush:
            flush.sum()
        else:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


#: the fused value kernel's C signature: 12 pointers, G D R U S T, stream
_SIG_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
#: the earlier kernel's, on a gathered cnt_fit: 10 pointers, G D R, stream
_OLD_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
SASS_OUT = PROBE_DIR / "value_kernel.sass"


def _sass_counts(lib_path: Path) -> None:
    """cuobjdump's SASS of the value kernel library: written whole to
    SASS_OUT, and per kernel instance (value_kernel<bf16, R, bits>) its
    instruction count and those of MUFU (one a division), FCHK, F2F and
    F2FP (bf16 roundings), STG, CALL and BRA."""
    from torch.utils.cpp_extension import CUDA_HOME

    text = subprocess.run(
        [str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass", str(lib_path)],
        capture_output=True, text=True, check=True, timeout=300).stdout
    SASS_OUT.parent.mkdir(parents=True, exist_ok=True)
    SASS_OUT.write_text(text)
    print(f"value kernel SASS: {SASS_OUT} ({len(text.splitlines())} lines)")
    for block in text.split("Function : ")[1:]:
        name = _kernel_name(block.splitlines()[0].strip())
        ops = collections.Counter(
            m.group(1).split(".")[0]
            for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                                 block))
        keys = ("MUFU", "FCHK", "F2F", "F2FP", "STG", "CALL", "BRA")
        print(f"  {name[:70]}: {sum(ops.values())} instructions, "
              + ", ".join(f"{k} {ops[k]}" for k in keys))


def value_section(kc, engine, gangs, flush, old_k1) -> None:
    """K1 on the stress operands: the fused kernel at its tiles, K1 with
    K2, and the earlier kernel with the gather and min."""
    dev = torch.device("cuda")
    vin = engine.value_inputs(gangs)
    dom_free, sig_cnt, sig_idx, dom_level, demand, demand_idx = vin[:6]
    (u, d), (g, s), (n_td, r) = sig_cnt.shape, sig_idx.shape, demand.shape
    td = demand[demand_idx.long()]
    cpu = [a.cpu() for a in vin]
    lib = load("value_kernel")
    stream = torch.cuda.current_stream().cuda_stream
    print(f"value kernel G={g} D={d} U={u} S={s} R={r} T={n_td} (distinct "
          f"demand rows)")
    outs = {}
    for precision, entry in kc._VALUE_ENTRY.items():
        ref = kc.VALUE_SIG_PLAIN[precision](*cpu)
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = _SIG_ARGTYPES, ctypes.c_int
        out = torch.empty((g, d), dtype=torch.float32, device=dev)

        def call(fn=fn, out=out):
            if fn(*[a.data_ptr() for a in vin], out.data_ptr(),
                  g, d, r, u, s, n_td, stream) != 0:
                raise RuntimeError("value kernel launch failed")
        ms = _median_ms(call, flush)
        print(f"  fused {precision}: {ms:.6f} ms, == plain on the CPU: "
              f"{torch.equal(out, ref.to(dev))}")
        outs[precision] = out
    value = outs["fp32"]
    anc = engine._statics[1]
    k, chunk = min(engine.top_k, d), engine.commit_chunk

    def k1():
        kc.kernel_value_sig(*vin)

    def k2():
        kc.kernel_commit_topk(value, dom_free, anc, td, k, chunk)

    def k1_k2():
        v = kc.kernel_value_sig(*vin)
        kc.kernel_commit_topk(v, dom_free, anc, td, k, chunk)
    fill = torch.empty((g, d), dtype=torch.float32, device=dev)
    print(f"  writing the same [G, D] f32 output with fill_ (a library "
          f"kernel): {_median_ms(lambda: fill.fill_(-1e9), flush):.6f} ms")
    t_k1, t_k2 = _median_ms(k1, flush), _median_ms(k2, flush)
    times = []
    for _ in range(REPS):  # K2 with the value tensor just written by K1
        flush.zero_()
        k1()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        k2()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    t_pair = _median_ms(k1_k2, flush)
    r_k1, r_k2 = (_median_ms(k1, flush, read_flush=True),
                  _median_ms(k2, flush, read_flush=True))
    r_pair = _median_ms(k1_k2, flush, read_flush=True)
    print(f"  K1 flushed {t_k1:.6f} ms, K2 flushed {t_k2:.6f} ms (sum "
          f"{t_k1 + t_k2:.6f}); K2 right after K1 {statistics.median(times):.6f}"
          f" ms; K1 then K2, one flush before the pair, {t_pair:.6f} ms")
    print(f"  flushed by a read: K1 {r_k1:.6f} ms, K2 {r_k2:.6f} ms (sum "
          f"{r_k1 + r_k2:.6f}); K1 then K2, one flush before the pair, "
          f"{r_pair:.6f} ms")
    _sass_counts(library_path("value_kernel"))
    src = (PACKAGE_DIR / "csrc/value_kernel.cu").read_text()
    logs: dict[str, str] = {}
    sources = {f"k1_{n}": (k1_variant(src, **kw), []) for n, kw in K1_VARIANTS.items()}
    sources["k1_probe"] = (probe_value(src), [])
    libs = _build(sources, logs)
    probe = libs["k1_probe"]
    probe.grove_probe_reset.argtypes = []
    for precision, entry in kc._VALUE_ENTRY.items():
        fn = getattr(probe, entry)
        fn.argtypes, fn.restype = _SIG_ARGTYPES, ctypes.c_int
        out = torch.empty((g, d), dtype=torch.float32, device=dev)
        flush.zero_()
        torch.cuda.synchronize()
        if probe.grove_probe_reset() != 0:
            raise RuntimeError("resetting the probe stamps failed")
        if fn(*[a.data_ptr() for a in vin], out.data_ptr(), g, d, r, u, s, n_td,
              stream) != 0:
            raise RuntimeError("value kernel probe launch failed")
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 16)()
        probe.grove_probe_read.argtypes = [ctypes.c_void_p]
        if probe.grove_probe_read(ctypes.addressof(buf)) != 0:
            raise RuntimeError("reading the probe stamps failed")
        print(f"  phases {precision}, thread 0 of block (0, 0) (== fused: "
              f"{torch.equal(out, outs[precision])}); the grid from its first "
              f"entry to its last exit {(buf[9] - buf[8]) / 1e3:.3f} us")
        for q, name in enumerate(VALUE_PHASES):
            print(f"    {name:36s} {buf[q]:10d} cycles")
    print("value kernel variants (registers of the stress instances "
          "value_kernel<0,3,1> and <1,3,1>)")
    for name in K1_VARIANTS:
        regs = [line for line in ptxas_lines(logs[f"k1_{name}"])
                if "<0,3,1>" in line or "<1,3,1>" in line]
        print(f"  {name}: " + " | ".join(regs))
        for precision, entry in kc._VALUE_ENTRY.items():
            fn = getattr(libs[f"k1_{name}"], entry)
            fn.argtypes, fn.restype = _SIG_ARGTYPES, ctypes.c_int
            out = torch.empty((g, d), dtype=torch.float32, device=dev)

            def call(fn=fn, out=out):
                if fn(*[a.data_ptr() for a in vin], out.data_ptr(),
                      g, d, r, u, s, n_td, stream) != 0:
                    raise RuntimeError("value kernel variant launch failed")
            ms = _median_ms(call, flush)
            print(f"    {precision}: {ms:.6f} ms, == fused: "
                  f"{torch.equal(out, outs[precision])}")
    if old_k1 is None:
        return
    old = _build({"old_k1": (open(old_k1).read(), [])})["old_k1"]
    for precision, entry in (("fp32", "grove_value"), ("bf16", "grove_value_bf16")):
        fn = getattr(old, entry)
        fn.argtypes, fn.restype = _OLD_ARGTYPES, ctypes.c_int
        out = torch.empty((g, d), dtype=torch.float32, device=dev)
        cnt = sig_cnt[sig_idx].amin(dim=1)

        old_args = (dom_level, td, *vin[6:])

        def old_kernel(fn=fn, out=out, cnt=cnt):
            if fn(dom_free.data_ptr(), cnt.data_ptr(),
                  *[a.data_ptr() for a in old_args], out.data_ptr(),
                  g, d, r, stream) != 0:
                raise RuntimeError("old value kernel launch failed")

        def gather_min():
            return sig_cnt[sig_idx].amin(dim=1)

        def old_path(fn=fn, out=out):
            c = sig_cnt[sig_idx].amin(dim=1)
            if fn(dom_free.data_ptr(), c.data_ptr(),
                  *[a.data_ptr() for a in old_args], out.data_ptr(),
                  g, d, r, stream) != 0:
                raise RuntimeError("old value kernel launch failed")
        t_old, t_gm = _median_ms(old_kernel, flush), _median_ms(gather_min, flush)
        t_path = _median_ms(old_path, flush)
        new = _median_ms(lambda p=precision: kc.kernel_value_sig(*vin, precision=p),
                         flush)
        print(f"  earlier K1 {precision}: kernel {t_old:.6f} ms, gather + amin "
              f"{t_gm:.6f} ms, both {t_path:.6f} ms; fused {new:.6f} ms "
              f"(x{t_path / new:.2f}); old == fused: "
              f"{torch.equal(out, outs[precision])}")


def _phases(lib, names, per: int) -> None:
    buf = (ctypes.c_ulonglong * 16)()
    lib.grove_probe_read.argtypes = [ctypes.c_void_p]
    if lib.grove_probe_read(ctypes.addressof(buf)) != 0:
        raise RuntimeError("reading the probe stamps failed")
    for q, name in enumerate(names):
        print(f"    {name:36s} {buf[q] / per:10.1f} cycles")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old-k1", help="an earlier value_kernel.cu (gathered "
                        "cnt_fit), timed with the gather and min")
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
    flush = torch.empty(50 * 2**20, dtype=torch.float32, device=dev)  # 4x L2
    value_section(kc, engine, stress.make_gangs(1000), flush, args.old_k1)
    value, dom_free, anc, td = engine.score_values(stress.make_gangs(1000))
    g, d = value.shape
    r, l1 = dom_free.shape[1], anc.shape[1]
    k, chunk = 8, 32
    cpu = [t.cpu() for t in (value, dom_free, anc, td)]
    ref_topk = kc.commit_topk_plain(*cpu, k, chunk)
    top_val, top_dom = (t.to(dev) for t in ref_topk)
    ref_scan = kc.device_commit_scan_plain(*ref_topk, *cpu[1:3], cpu[3])
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

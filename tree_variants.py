#!/usr/bin/env python3
"""Times forms of the tree rasterizer's group fold against each other on one card.

    python3 tree_variants.py [NAME ...]

Each form is csrc/rasterize.cu with its fold (``tree_leaf`` and
``fold_group``) replaced, and ``TREE_MIN_BLOCKS`` (CTAs per SM) set; every
form folds the fixed tree ((0 o 1) o (2 o 3)) o ((4 o 5) o (6 o 7)) over a
group's present positions, so each must give the plain tree composite's
image bit for bit.  The forms (default: all):
  shipped, shipped_4   the file as it is (one or two present records fold
                       only those, three or more all 8 positions), at its
                       own CTAs per SM and at 4
  wide, wide_3         all 8 positions for every group (7 overs), at 4 and
                       3 CTAs per SM
  walk                 only the present positions for every group: an
                       __ffs walk in ascending position, merged by the
                       position bits (m - 1 overs)
  closed3_walk         closed forms for 1-3 present records, the walk past
  closed3_wide         closed forms for 1-3, all 8 positions past
  smem_closed4_walk2   closed forms for 1-4, a walk two leaves at a time
                       past, and the pixels' state in shared memory so the
                       fold's code exists once rather than once per
                       sub-block
Each form is compiled by its own nvcc (all started together, the kernel
build's flags) into its own library; ptxas' registers and spills and the
kernel's SASS instruction count are printed.  On the bench scene's view 0
(chip_smoke.py's scene, 1200x799) the script renders the sorted stream with
each form, checks it against rasterize_torch (composite="tree") with
torch.equal, prints how many present records the kernel's folds hold (a
histogram from an instrumented copy of the file), then times the forms in
turns: 6 rounds of 15 launches each (CUDA events), median and quartiles.
Needs CUDA; exits nonzero without it.
"""

from __future__ import annotations

import ctypes
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(ROOT, "websplat_tpu_torch", "csrc", "rasterize.cu")
FOLD_START = "// The (alpha * rgb, 1 - alpha) pair of record s"
FOLD_END = "// The tree composite over the four 8-record groups"
BLOCKS = re.compile(r"constexpr int TREE_MIN_BLOCKS = \d+;")

LEAF = r"""
__device__ __forceinline__ float4 tree_leaf(int s, float cx, float cy, const float4* s_ra,
                                            const float4* s_rb, const float* s_rc) {
  const float4 ra = s_ra[s], rb = s_rb[s];
  const float dx = cx - ra.x;
  const float dy = cy - ra.y;
  const float a = ra.z * dx * dx + ra.w * dx * dy + rb.x * dy * dy;
  const float alpha = fminf(0.99f, expf(-a) * rb.y);
  return a < CUTOFF2 && rb.y > 0.0f
             ? make_float4(alpha * rb.z, alpha * rb.w, alpha * s_rc[s], 1.0f - alpha)
             : make_float4(0.0f, 0.0f, 0.0f, 1.0f);
}
#define LEAF(s) tree_leaf((s), cx, cy, s_ra, s_rb, s_rc)
#define FOLD_ARGS float cx, float cy, const float4 *s_ra, const float4 *s_rb, const float *s_rc
__device__ __forceinline__ void walk_merge(float4& acc, float4& q, float4& h, bool& hq, bool& hh,
                                           int& j, int i, float4 e) {
  const int x = i ^ j;  // the highest differing bit is the level at which i joins
  j = i;
  if (x < 2) { acc = over(acc, e); return; }
  if (x < 4) { q = acc; hq = true; }
  else { if (hq) acc = over(q, acc); h = acc; hh = true; hq = false; }
  acc = e;
}
// the present positions in occ after position j, whose fold so far is acc
__device__ __forceinline__ float4 fold_walk(uint32_t occ, int j, float4 acc, int s0, FOLD_ARGS) {
  float4 q = acc, h = acc;
  bool hq = false, hh = false;
  for (; occ != 0u; occ &= occ - 1u) {
    const int i = __ffs(occ) - 1;
    walk_merge(acc, q, h, hq, hh, j, i, LEAF(s0 + i));
  }
  if (hq) acc = over(q, acc);
  if (hh) acc = over(h, acc);
  return acc;
}
__device__ __forceinline__ float4 fold_walk2(uint32_t occ, int j, float4 acc, int s0, FOLD_ARGS) {
  float4 q = acc, h = acc;
  bool hq = false, hh = false;
  while (occ != 0u) {
    const int i1 = __ffs(occ) - 1;
    const uint32_t r = occ & (occ - 1u);
    const int i2 = r != 0u ? __ffs(r) - 1 : i1;
    const float4 e1 = LEAF(s0 + i1), e2 = LEAF(s0 + i2);
    walk_merge(acc, q, h, hq, hh, j, i1, e1);
    if (r != 0u) walk_merge(acc, q, h, hq, hh, j, i2, e2);
    occ = r & (r - 1u);
  }
  if (hq) acc = over(q, acc);
  if (hh) acc = over(h, acc);
  return acc;
}
"""
HEAD = "__device__ __forceinline__ float4 fold_group(uint32_t occ, int s0, FOLD_ARGS) {\n"
WIDE = r"""
  float4 pr, qd, hf;
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    float4 e = make_float4(0.0f, 0.0f, 0.0f, 1.0f);
    if ((occ >> j) & 1u) e = LEAF(s0 + j);
    if (j % 2 == 0) pr = e; else pr = over(pr, e);
    if (j % 4 == 1) qd = pr; else if (j % 4 == 3) qd = over(qd, pr);
    if (j == 3) hf = qd; else if (j == 7) hf = over(hf, qd);
  }
  return hf;
}
"""
CLOSED3 = r"""
  const int j = __ffs(occ) - 1;
  const uint32_t r1 = occ & (occ - 1u);
  if (r1 == 0u) return LEAF(s0 + j);
  const int i = __ffs(r1) - 1;
  const uint32_t r2 = r1 & (r1 - 1u);
  if (r2 == 0u) return over(LEAF(s0 + j), LEAF(s0 + i));
  const int l = __ffs(r2) - 1;
  const uint32_t r3 = r2 & (r2 - 1u);
  if (r3 == 0u) {
    const float4 a = LEAF(s0 + j), b = LEAF(s0 + i), c = LEAF(s0 + l);
    return (j ^ i) < (i ^ l) ? over(over(a, b), c) : over(a, over(b, c));
  }
"""
CLOSED4 = CLOSED3 + r"""
  const int n = __ffs(r3) - 1;
  if ((r3 & (r3 - 1u)) == 0u) {
    const float4 a = LEAF(s0 + j), b = LEAF(s0 + i), c = LEAF(s0 + l), d = LEAF(s0 + n);
    const int x0 = j ^ i, x1 = i ^ l, x2 = l ^ n;  // the root joins at the largest
    if (x1 > x0 && x1 > x2) return over(over(a, b), over(c, d));
    if (x0 > x2) return over(a, x1 < x2 ? over(over(b, c), d) : over(b, over(c, d)));
    return over(x0 < x1 ? over(over(a, b), c) : over(a, over(b, c)), d);
  }
"""
FOLDS = {
    "wide": HEAD + WIDE,
    "walk": HEAD + "  const int j = __ffs(occ) - 1;\n"
    "  return fold_walk(occ & (occ - 1u), j, LEAF(s0 + j), s0, cx, cy, s_ra, s_rb, s_rc);\n}\n",
    "closed3_walk": HEAD + CLOSED3
    + "  return fold_walk(r1, j, LEAF(s0 + j), s0, cx, cy, s_ra, s_rb, s_rc);\n}\n",
    "closed3_wide": HEAD + CLOSED3 + WIDE,
    "closed4_walk2": HEAD + CLOSED4
    + "  return fold_walk2(r1, j, LEAF(s0 + j), s0, cx, cy, s_ra, s_rb, s_rc);\n}\n",
}
# tree_groups with the pixels' state in shared memory: a loop over the
# warp's sub-blocks that a group meets runs ONE copy of the fold
SMEM_GROUPS = r"""
__device__ __forceinline__ bool tree_groups(int c0, uint32_t mine, float* cx, float* cy, float* T,
                                            float* cr, float* cg, float* cb, const float4* s_ra,
                                            const float4* s_rb, const float* s_rc, float eps) {
  __shared__ float s_st[6][MAX_PIX_PER_THREAD][RASTER_THREADS];
  uint32_t occ[MAX_PIX_PER_THREAD], any = 0u;
#pragma unroll
  for (int k = 0; k < MAX_PIX_PER_THREAD; ++k) {
    occ[k] = __ballot_sync(FULL_MASK, (mine >> k) & 1u);
    any |= occ[k];
  }
  if (any == 0u) return true;
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < MAX_PIX_PER_THREAD; ++k) {
    s_st[0][k][tid] = cx[k]; s_st[1][k][tid] = cy[k]; s_st[2][k][tid] = T[k];
    s_st[3][k][tid] = cr[k]; s_st[4][k][tid] = cg[k]; s_st[5][k][tid] = cb[k];
  }
  bool live_any = true;
  for (int g = 0; g < 32 / GROUP; ++g) {
    if (((any >> (GROUP * g)) & 0xFFu) == 0u) continue;
    uint32_t all = 0u, km = 0u;
#pragma unroll
    for (int k = 0; k < MAX_PIX_PER_THREAD; ++k) {
      const uint32_t o = (occ[k] >> (GROUP * g)) & 0xFFu;
      all |= o << (8 * k);
      km |= o != 0u ? 1u << k : 0u;
    }
#pragma unroll 1
    for (; km != 0u; km &= km - 1u) {
      const int kk = __ffs(km) - 1;
      const float t = s_st[2][kk][tid];
      if (t > eps) {
        const float4 hf = fold_group((all >> (8 * kk)) & 0xFFu, c0 + GROUP * g,
                                     s_st[0][kk][tid], s_st[1][kk][tid], s_ra, s_rb, s_rc);
        s_st[3][kk][tid] = s_st[3][kk][tid] + t * hf.x;
        s_st[4][kk][tid] = s_st[4][kk][tid] + t * hf.y;
        s_st[5][kk][tid] = s_st[5][kk][tid] + t * hf.z;
        s_st[2][kk][tid] = t * hf.w;
      }
    }
    bool live = false;
#pragma unroll
    for (int k = 0; k < MAX_PIX_PER_THREAD; ++k) live = live || (s_st[2][k][tid] > eps);
    if (!__any_sync(FULL_MASK, live)) { live_any = false; break; }
  }
#pragma unroll
  for (int k = 0; k < MAX_PIX_PER_THREAD; ++k) {
    T[k] = s_st[2][k][tid]; cr[k] = s_st[3][k][tid]; cg[k] = s_st[4][k][tid];
    cb[k] = s_st[5][k][tid];
  }
  return live_any;
}
"""
# name: (fold or None for the file's own, CTAs per SM or None for the file's, smem state)
FORMS = {
    "shipped": (None, None, False),
    "shipped_4": (None, 4, False),
    "wide": ("wide", 4, False),
    "wide_3": ("wide", 3, False),
    "walk": ("walk", 4, False),
    "closed3_walk": ("closed3_walk", 4, False),
    "closed3_wide": ("closed3_wide", 4, False),
    "smem_closed4_walk2": ("closed4_walk2", 4, True),
}


def form_source(src: str, fold, blocks, smem: bool) -> str:
    if blocks is not None:
        src = BLOCKS.sub(f"constexpr int TREE_MIN_BLOCKS = {blocks};", src)
    if fold is None:
        return src
    a, b = src.index(FOLD_START), src.index(FOLD_END)
    if not smem:
        return src[:a] + LEAF + FOLDS[fold] + "\n" + src[b:]
    c = src.index("template <bool TREE>")
    return src[:a] + LEAF + FOLDS[fold] + "\n" + SMEM_GROUPS + "\n" + src[c:]


def histogram_source(src: str) -> str:
    """The file with each (group, sub-block) fold counted by its present
    records (lane 0 of a warp with a live pixel there), read back by
    ws_tree_hist."""
    site = "      if (o != 0u && T[k] > eps) {"
    if site not in src:
        raise SystemExit("tree_variants: csrc/rasterize.cu's fold call site changed")
    src = src.replace(site, "      if (o != 0u && __any_sync(FULL_MASK, T[k] > eps) && "
                            "(threadIdx.x & 31) == 0)\n        atomicAdd(&g_hist[__popc(o)], 1ull);\n"
                      + site)
    src = src.replace("constexpr int GROUP = 8;", "constexpr int GROUP = 8;\n"
                      "__device__ unsigned long long g_hist[9];")
    return src.replace('extern "C" {', 'extern "C" {\nint ws_tree_hist(unsigned long long* h, '
                       'int reset) {\n  if (reset) { unsigned long long z[9] = {0}; return (int)'
                       'cudaMemcpyToSymbol(ws::g_hist, z, sizeof(z)); }\n  return (int)'
                       'cudaMemcpyFromSymbol(h, ws::g_hist, sizeof(ws::g_hist));\n}\n', 1)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tree_variants: torch.cuda.is_available() is False -- needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from websplat_tpu_torch import GaussianRenderer, RasterConfig
    from websplat_tpu_torch.kernels import build
    from websplat_tpu_torch.ops import packing
    from websplat_tpu_torch.ops.preprocess import N_SCALARS
    from websplat_tpu_torch.ops.rasterize import rasterize_torch, warp_layout
    from websplat_tpu_torch.ops.sort import sort_instances, tile_ranges
    from websplat_tpu_torch.render.renderer import build_instance_stream
    from websplat_tpu_torch.synth import bench_cameras

    names = sys.argv[1:] or list(FORMS)
    src = open(SOURCE).read()
    out_dir = os.path.join(build.BUILD_DIR, "tree_variants")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = build.nvcc_path()
    sources = {n: form_source(src, *FORMS[n]) for n in names}
    sources["histogram"] = histogram_source(src)
    procs = {}
    for n, text in sources.items():
        cu = os.path.join(out_dir, f"{n}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[n] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", str(build.CSRC), "-o",
             os.path.join(out_dir, f"{n}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    cloud = cs.bench_cloud()
    renderer = GaussianRenderer(cloud, RasterConfig())
    block = cs.device_block(*cs.view_block(cloud, bench_cameras()[0]))
    cfg = renderer.config
    geo = dict(width=cs.W, height=cs.H, config=cfg)
    keys, words, _ = build_instance_stream(renderer.device_cloud, block, **geo)
    sk, sw = sort_instances(keys, words)
    tx, ty = cfg.tiles_for(cs.W, cs.H)
    ranges = tile_ranges(sk, tx * ty, cfg.key_bits(cs.W, cs.H)[1])
    bg = block[N_SCALARS:]
    plain = rasterize_torch(sw, ranges, bg, **dict(geo, config=RasterConfig(composite="tree")))

    libs = {}
    for n, p in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise SystemExit(f"tree_variants: nvcc failed on {n}:\n{err}")
        entry = None
        for line in err.splitlines():
            if "Compiling entry function" in line:
                entry = line
            elif entry and "rasterize_tree" in entry and ("Used" in line or "spill" in line):
                print(f"[ptxas] {n}: {line.split(':', 1)[-1].strip()}", flush=True)
        so = os.path.join(out_dir, f"{n}.so")
        dump = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", so],
                              capture_output=True, text=True, check=True).stdout
        count, cur = 0, False
        for line in dump.splitlines():
            if "Function : " in line:
                cur = "rasterize_tree" in line
            elif cur and re.search(r"/\*[0-9a-f]{4}\*/", line):
                count += 1
        print(f"[sass] {n}: rasterize_tree_kernel {count} instructions", flush=True)
        lib = ctypes.CDLL(so)
        lib.ws_rasterize.argtypes = build._SIGNATURES["ws_rasterize"]
        lib.ws_rasterize.restype = ctypes.c_int
        libs[n] = lib

    cq = packing.CenterQuant.for_viewport(cs.W, cs.H)
    out = torch.empty((cs.H, cs.W, 3), dtype=torch.float32, device="cuda")

    def run(lib) -> None:
        err = lib.ws_rasterize(sw.data_ptr(), sw.shape[1], ranges.data_ptr(),
                               bg.data_ptr(), out.data_ptr(), cs.W, cs.H,
                               cfg.tile_w, cfg.tile_h, tx, warp_layout(cfg.tile_w, cfg.tile_h),
                               float(cfg.transmittance_eps), cq.margin, cq.scale_x, cq.scale_y,
                               1, build.stream_ptr(sw.device))
        if err:
            raise SystemExit(f"tree_variants: launch failed ({err})")

    hist = (ctypes.c_ulonglong * 9)()
    libs["histogram"].ws_tree_hist(hist, 1)
    run(libs["histogram"])
    torch.cuda.synchronize()
    libs["histogram"].ws_tree_hist(hist, 0)
    folds = sum(hist)
    print(f"[folds] {folds} (group, sub-block) folds by present records 0-8: {list(hist)}; "
          f"{sum(i * v for i, v in enumerate(hist)) / max(folds, 1):.3f} per fold", flush=True)
    ok = True
    for n, lib in libs.items():
        out.fill_(-1.0)
        run(lib)
        torch.cuda.synchronize()
        equal = bool(torch.equal(out, plain))
        ok &= equal
        print(f"[check] {n}: bit-equal to plain {equal}, max abs "
              f"{float((out - plain).abs().max()):.3g}", flush=True)
    del libs["histogram"]
    times = {n: [] for n in libs}
    for _ in range(6):
        for n, lib in libs.items():
            for _ in range(3):
                run(lib)
            events = []
            for _ in range(15):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                run(lib)
                b.record()
                events.append((a, b))
            torch.cuda.synchronize()
            times[n] += [a.elapsed_time(b) for a, b in events]
    for n, ts in times.items():
        q = statistics.quantiles(ts, n=4)
        print(f"[time] {n}: median {statistics.median(ts):.4f} ms (quartiles {q[0]:.4f}, "
              f"{q[2]:.4f})", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""Design sweeps and splits of K6 (the 3x3x3 depthwise convolution), of
K2's graph transpose, of the fused EdgeConv gather-reduce, of K3, of K4's
histogram, of the approximate top-k's kernels and of the streaming column
sums on the card, from scratch builds of edited sources. Run from the
repository root:

    python fissure_segmentation_tpu_torch/prof/design_sweep.py \
        [--parts split,dw,tr,gr,grb,grc,k3,k4,sel,bins,st] [--build DIR]
        [--no_grid] [--only NAME,...]

Each variant is a copy of kernels/csrc/depthwise.cu, scatter.cu,
gather_reduce.cu, approx_topk.cu or stream.cu with one constant, launch
shape or path edited, built alone by nvcc into DIR (default: a temporary
directory) and called through ctypes; the package keeps no knob for any of
them. Every variant that computes the kernel's function is checked first
(K6, the gather-reduce and the approximate top-k's kernels bit-equal to
plain, the transpose equal, K3 equal to the package's kernel, the stream
sums equal to plain on integers). Parts:

  split  what holds a kernel back, at the path shapes: the simple K6 kernel
         (`depthwise_simple`, now the path of channel rows that are not
         16-byte multiples) as it is, without its loads, with loads and
         adds but no products, and a plain copy of x to y; K2's wrapper at
         (32, 81 920, 64) by its parts (the plain transpose's flat targets,
         stable sort and searchsorted, the transpose kernel, the row sums);
         the gather-reduce on its route and the unstaged kernel forced, as
         it is and with its loads alone, and a copy of its bytes through
         L2; K3,
         staged and the unstaged kernel forced, as it is, its dense half alone
         and its routing half alone;
  dw     the tiled K6 kernel's launch shape (slice, tile, run, stages, the
         D-split target) at the CNN's seven stride-1 layers and bf16;
  tr     the transpose's constants (chunk, warps a block, steps loaded
         together, counters in shared or device memory, lanes matched by
         ballots instead of __match_any_sync), each stage timed;
  gr     the staged gather-reduce's warps a block, unroll, NaN-free
         comparisons, and every slot reading one row (no bank conflicts);
  grb    the gather-reduce by batch size, f32 at (B, 2048, 40, 64), B = 5
         ... 32: the staged kernel at the uncapped split of `staged_parts`'
         model, the unstaged kernel and the model's route (the source of
         `staged_parts`' model; the routes forced through the library
         entry's (route, parts, cluster));
  grc    the few-cloud routes (the staged kernel split into more blocks
         a slice, and the thread-block clusters that share a staged
         slice) at (B, 2048, 40, 64) "extrema", f32 and bf16, B = 1, 2, 3,
         5, 7, 9, 13, 14, and DPSR-Net's (5 and 1, 1024, 20, 64) f32, on
         the card alone (`graph_ms`): the model's route (and its issue
         slots a lane-value), the unstaged kernel, the staged kernel at
         1 ... 16 blocks a slice, the clusters of each size that fit on the
         card (the model's waves), and where the grid is on (the builds
         "multicast", the shipped one, and "lanes_2", "lanes_1": 32- and
         16-byte slices, 2 and 1 lanes a point) every forced (cluster size
         2 ... 16; clusters a slice 1 ... 4) whose clusters fit. The
         sharing schemes: the shipped one ("multicast": each block copies
         its rows from device memory into every block of the cluster as
         boxes of 64 rows of a tensor map, multicast by the TMA), "push"
         (each block copies its rows and pushes them to its peers),
         "peers" (rows read in place through distributed shared memory);
         the inner loop with 8 rows read ahead ("unroll_8"), without FMNMX
         ("no_fmnmx"), without its index loads ("abl_no_fetch"), without
         its row reads ("abl_no_rows"), its loads alone
         ("abl_loads_only"); every route's outputs equal to plain (the
         abl_ variants aside); a timeline of each block's phases on the
         model's route ("abl_timeline": %globaltimer at its entry, its
         own rows copied, the slice in, the NaN flags, its points done, its
         end). Each gather-reduce build is timed in a process of its own
         (--one); --no_grid skips the grid, --only picks variants;
  k3     the staged K3's warps a block, edge ids a lane, and every edge
         reading one node;
  k4     K4's histogram (`count_hist`): an empty launch (the floor of a
         cluster launch), the loads alone (each target compared, none
         counted), the cluster of P blocks a batch element against one
         block of 512 or 1024 threads, P forced to 1, 2, 4, 8, threads and
         loads in flight; at (32, 81 920) to 2048 and 512 rows, and by
         batch size at 2048 rows (B = 1 ... 32, E = 81 920); the checked
         variants also time `count_from_ptr` at each case. K4's times are
         CUDA-graph replays (`prof.timing.graph_ms`): one launch is shorter
         than a ctypes call;
  sel    the fused row selection (`select_rows`) at the kNN rows of the
         --knn_recall step ((32 * 2048, 2048) -> 40 at L = 512 x 4, f32
         coordinate and bf16 feature distances), the exact feature graph
         (bf16, one element a bin, kk = 41) and the fast-serving static
         graph's (10 240, 2048) f32: rows a block, loads in flight, blocks
         an SM (registers capped), no vectors (one element a lane), the
         threshold tested on the values before keys are built, K1's way of
         adding keys instead of the buffer (a round with 8 or 4 keys or more
         below the threshold merged, fewer inserted one at a time), and the
         loads and keys alone (no selection: the floor of its memory side);
  bins   the bin pass at (1, 256^3), L = 524 288 x 32, f32 and bf16, timed
         cold (`prof.timing.cold_ms`) and warm: as it is, without vectors
         (the PR 17 kernel's one element a thread) and with 4 or 16 loads
         in flight.

  st     the streaming column sums (stream.cu): loads in flight a thread
         (ST_UNROLL 4, 8, 16), stream_sum's blocks an SM (1, 2, 4), the
         loads as __ldcs instead of L1::no_allocate with an L2 evict-first
         policy, the producer's bulk copies cut to 16 or 4 KB, the ring's
         blocks an SM capped at 2, groups of 4 or 64 blocks in the finish,
         full fences around the tickets, stream_sum's units in balanced
         contiguous ranges instead of dealt to the blocks in turn, 4 loads
         in flight at 8 blocks an SM, and both kernels without their
         finish (an ablation: the streaming and the block's partial
         alone);
         at P1's (2 621 440, 64) bf16 view, its float32 copy and P3's
         (1 310 720, 128) view over ASYNC_GRID, each equal to plain on an
         integer payload first.

Prints one JSON line ({part: {variant: {shape: median ms}}}), then the
card's name and power limit. Raises without a card or nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from fissure_segmentation_tpu_torch.kernels import _build  # noqa: E402
from fissure_segmentation_tpu_torch.kernels import scatter as ks  # noqa: E402
from fissure_segmentation_tpu_torch.kernels.depthwise import (  # noqa: E402
    depthwise_conv3_plain)
from fissure_segmentation_tpu_torch.kernels.knn import knn_cuda  # noqa: E402
from fissure_segmentation_tpu_torch.prof.timing import (  # noqa: E402
    cold_ms, graph_ms, median_ms)

CSRC = os.path.join(os.path.dirname(HERE), "kernels", "csrc")
F32_TILE = "launch_tiled<float, 32, 8, 16, 4, 3, 1, 1>("
BF16_TILE = "launch_tiled<__nv_bfloat16, 32, 8, 16, 4, 3, 1, 1>("
SPLIT_TARGET = "#define DW_TARGET_BLOCKS 1056"


def _tiles(cfg: str) -> dict:
    """Both dtypes' stride-1 tiled launch in shape `cfg` (CS, TH, TW, RW,
    ST)."""
    return {F32_TILE: f"launch_tiled<float, {cfg}, 1, 1>(",
            BF16_TILE: f"launch_tiled<__nv_bfloat16, {cfg}, 1, 1>("}


# the simple kernel forced onto every shape, and three ablations of it
_SIMPLE_ONLY = {"    if (aligned && stride == 1)": "    if (false)",
                "    if (aligned)\n": "    if (false)\n"}
_NO_LOADS = {"? to_f32(row[(size_t)xv * c]) : 0.0f;":
             "? __int_as_float(0x3f800000 ^ (int)((g + j * 7 + dz * 3 + dy)"
             " & 0x7fff)) : 0.0f;"}
_NO_PRODUCTS = {
    "acc[t] = __fadd_rn(acc[t], __fmul_rn(v[S * t + dx], wt));":
    "acc[t] = __fadd_rn(acc[t], v[S * t + dx]);"}
_SIMPLE_S1 = "    if (stride == 1)\n        return dtype == 0\n"
_COPY = {_SIMPLE_S1:
         "    if (dtype >= 0) {\n        const long long n16 = (long long)b"
         " * d * h * wd * c * (dtype ? 2 : 4) / 16;\n        copy16<<<132 *"
         " 16, 256, 0, s>>>((const uint4*)x, (uint4*)y, n16);\n        "
         "return (int)cudaGetLastError();\n    }\n" + _SIMPLE_S1,
         "// ---- the tiled kernel": "__global__ void copy16(const uint4* x, "
         "uint4* y, long long n) {\n    for (long long i = blockIdx.x * "
         "(long long)blockDim.x + threadIdx.x; i < n; i += (long long)"
         "gridDim.x * blockDim.x) y[i] = x[i];\n}\n\n// ---- the tiled kernel"}

# the gather-reduce's split: the staged kernel and the unstaged kernel (kept as
# the path of clouds whose slice does not fit in shared memory) forced onto
# the path shapes, each as it is and with its loads alone (each value
# folded into the max by one XOR instead of the reductions); and a copy
# that reads the table K times through L2 and writes the outputs' bytes.
# The gather-reduce's routes are forced by the (route, parts, cluster)
# its library entry takes: ROUTE_UNSTAGED, or the staged
# kernel at the split `_staged_parts` finds uncapped (ROUTE_STAGED).
ROUTE_UNSTAGED, ROUTE_STAGED = "unstaged", "staged"

# The few-cloud part's sharing schemes, each an edit of the cluster route
# (whose blocks copy their own rows as boxes of a tensor map from device
# memory into every block of the cluster, multicast by the TMA, completing
# on each block's mbarrier): (b) "push", each block copies its rows into
# its own shared memory (16-byte cp.async) and pushes them to each peer with
# one bulk copy (shared::cta -> shared::cluster, onto the peer's mbarrier);
# (c) "peers", no copies between blocks: every slice row read in place
# through distributed shared memory from the block that copied it (`mapa`,
# ld.shared::cluster), a cluster barrier at the end.
_GRC_PUSH = {
    # the peers' rows alone arrive on the mbarrier
    "                     :: \"r\"(bar), \"r\"((unsigned)(nrow * ROW)) : "
    "\"memory\");":
    "                     :: \"r\"(bar), \"r\"((unsigned)((nrow - (rr1 - rr0))"
    " * ROW))\n                     : \"memory\");",
    # each block copies its own rows (the cluster) or the slice (staged)
    "    if (!CL) {\n        // the whole slice copied by this block: 16-byte "
    "asynchronous\n":
    "    if (true) {\n        // the whole slice copied by this block: 16-byte "
    "asynchronous\n",
    "        for (int q = threadIdx.x; q < n * LPP; q += NW * 32) {\n":
    "        for (int q = (CL ? rr0 : 0) * LPP + threadIdx.x;\n"
    "             q < (CL ? min(rr1, n) : n) * LPP; q += NW * 32) {\n",
    "    } else {\n        // once every peer's mbarrier is armed, boxes of "
    "rows [rr0, rr1)\n":
    "    }\n    if (CL) {\n        // once every peer's mbarrier is armed, "
    "boxes of rows [rr0, rr1)\n",
    "        for (int r = rr0 + GC_BOX * (int)threadIdx.x; r < rr1;\n":
    "        for (int r = rr0 + GC_BOX * (int)threadIdx.x; false && r < rr1;\n",
    "        wait_parity(bar, 0);   // the slice, own rows too, is in\n":
    "",
    # the rows, written by this block's threads, read by bulk copies: pushed
    # to each peer once the block has them
    "    asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n"
    "    __syncthreads();\n":
    """    asm volatile("cp.async.wait_all;\\n" ::: "memory");
    if (CL) asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
    __syncthreads();
    if (CL && (int)threadIdx.x < csize && (int)threadIdx.x != crank &&
        rr1 > rr0) {
        const unsigned src = smem_u32(slice) + rr0 * ROW;
        asm volatile(
            "cp.async.bulk.shared::cluster.shared::cta.mbarrier::"
            "complete_tx::bytes [%0], [%1], %2, [%3];\\n"
            :: "r"(mapa(src, threadIdx.x)), "r"(src),
               "r"((unsigned)((rr1 - rr0) * ROW)), "r"(mapa(bar, threadIdx.x))
            : "memory");
    }
""",
    "        wait_parity(fbar, 0);\n":
    "        wait_parity(bar, 0);   // the peers' rows are in\n"
    "        wait_parity(fbar, 0);\n",
}
_GRC_PEERS = {
    **_GRC_PUSH,
    "__device__ __forceinline__ void cluster_arrive() {":
    """__shared__ int gc_per;   // rows a block copies (1 << 30 without CL)

__device__ __forceinline__ uint4 ldc16(unsigned addr) {
    uint4 v;
    asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
    return v;
}

__device__ __forceinline__ void cluster_arrive() {""",
    # nothing arrives on the rows' mbarrier: nothing is pushed
    "                     :: \"r\"(bar), \"r\"((unsigned)((nrow - (rr1 - rr0))"
    " * ROW))":
    "                     :: \"r\"(bar), \"r\"(0u)",
    "    if (CL && (int)threadIdx.x < csize && (int)threadIdx.x != crank &&\n"
    "        rr1 > rr0) {\n":
    "    if (false) {\n",
    "        cluster_arrive();\n    } else {   // the whole slice scanned":
    "    } else {   // the whole slice scanned",
    "    if (CL) cluster_wait();\n}":
    "    if (CL) {\n        cluster_arrive();\n        cluster_wait();\n"
    "    }\n}",
    "    const int rr0 = min(nrow, crank * rper), rr1 = min(nrow, rr0 + rper);\n":
    "    const int rr0 = min(nrow, crank * rper), rr1 = min(nrow, rr0 + rper);\n"
    "    if (threadIdx.x == 0) gc_per = CL ? rper : 1 << 30;\n",
    "                unpack16(lds16(lane_s + r * ROW), w[u], T());":
    "                unpack16(ldc16(mapa(lane_s + r * ROW, (unsigned)r / "
    "gc_per)), w[u], T());",
}
# 32- and 16-byte slices (2 and 1 lanes a point) instead of 64-byte ones:
# the staged and cluster routes' rows, points a warp and the route's slices
_GRC_LANES = {
    lanes: {"#define GS_ROW 64 ": f"#define GS_ROW {16 * lanes} ",
            "#define GS_LPP 4 ": f"#define GS_LPP {lanes} ",
            "#define GS_PPW 8 ": f"#define GS_PPW {32 // lanes} "}
    for lanes in (2, 1)}
# a timeline of each block (%globaltimer, ns, by thread 0): entry; its own
# rows copied or their copies issued (after the block barrier); the whole
# slice in (cluster: after its mbarrier); the NaN flags in; every warp's
# points done (a block barrier added); the end (cluster: after the last
# cluster barrier)
_GRC_TIMELINE = {
    "__device__ __forceinline__ void cluster_arrive() {":
    """__device__ long long gc_tl[8192 * 8];
__device__ __forceinline__ void gc_mark(int i) {
    if (threadIdx.x == 0 && blockIdx.x < 8192) {
        long long t;
        asm volatile("mov.u64 %0, %%globaltimer;\\n" : "=l"(t) :: "memory");
        gc_tl[blockIdx.x * 8 + i] = t;
    }
}
extern "C" int gc_timeline(long long* out, int blocks) {
    return (int)cudaMemcpyFromSymbol(out, gc_tl,
                                     (size_t)blocks * 8 * sizeof(long long));
}

__device__ __forceinline__ void cluster_arrive() {""",
    "    const int n0 = min(n, part * per), n1 = min(n, n0 + per);\n":
    "    const int n0 = min(n, part * per), n1 = min(n, n0 + per);\n"
    "    gc_mark(0);\n",
    "    asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n"
    "    __syncthreads();\n":
    "    asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n"
    "    __syncthreads();\n    gc_mark(1);\n",
    "        wait_parity(bar, 0);   // the slice, own rows too, is in\n":
    "        wait_parity(bar, 0);   // the slice, own rows too, is in\n"
    "        gc_mark(2);\n",
    "    spec = __syncthreads_or(spec);\n":
    "    spec = __syncthreads_or(spec);\n    gc_mark(3);\n",
    "        for (int i = 0; i < csize; ++i) spec |= flags[i] != 0;\n":
    "        for (int i = 0; i < csize; ++i) spec |= flags[i] != 0;\n"
    "        gc_mark(3);\n",
    "    if (CL) cluster_wait();\n}":
    "    __syncthreads();\n    gc_mark(4);\n    if (CL) cluster_wait();\n"
    "    gc_mark(5);\n}",
}
GRC_PHASES = ("own_rows", "slice", "scan", "points", "end")
# the inner loop's parts: the index rows made up (no loads from device
# memory); the slice rows made up from the indices (no shared-memory reads
# of the rows); the loads alone (each value folded in by one XOR)
_GRC_ABLATIONS = {
    "abl_no_fetch": {
        "        v[i] = __ldg(idx + (cloud + p2) * (long long)kk + s);":
        "        v[i] = (p2 * 131 + s * 17) & 1023;"},
    "abl_no_rows": {
        "                unpack16(lds16(lane_s + r * ROW), w[u], T());":
        "                unpack16(make_uint4(r, r + 1, r + 2, r + 3), w[u], "
        "T());"},
}

# the inner loop: 8 rows read before they are reduced; max and min by
# compare and select on every slice (no FMNMX)
_GRC_LOOP = {
    "unroll_8": {"#define GS_UNROLL 4 ": "#define GS_UNROLL 8 "},
    "no_fmnmx": {"                if (!SPECIAL && WANT < 2) {":
                 "                if (false) {"},
}


def _gr_loads_only(var: str, indent: int) -> dict:
    line = f"{' ' * indent}const float x = {var}[u][i];\n"
    indent = line[:len(line) - len(line.lstrip())]
    return {line: f"{line}{indent}if (true) {{\n{indent}    mx[i] = "
                  f"__int_as_float(__float_as_int(mx[i]) ^ __float_as_int(x))"
                  f";\n{indent}    continue;\n{indent}}}\n"}


# K3's split: the staged kernel and the unstaged kernel (kept as the path of
# clouds whose slices do not fit, or K > 255) forced onto the path shape,
# each as it is, with its dense half alone (no routing) and with its
# routing half alone (kstar and s, no p)
_K3_SIMPLE = {"    if (kk <= 255 && bf16 &&": "    if (false && bf16 &&",
              "    if (kk <= 255 && !bf16 &&": "    if (false && !bf16 &&"}
_K3_DENSE_ONLY = {
    "                    const uint32_t hit = kb[e].hits(rep, h);\n":
    "                    const uint32_t hit = 0u * rep;\n",
    "                if (kstar[base + ch] == slot)\n                    as[i] = "
    "__fadd_rn(as[i], to_f32<T>(s[base + ch]));\n": ""}
_K3_ROUTING_ONLY = {
    "                for (int i = 0; i < VEC; ++i) ap[i] = __fadd_rn(ap[i], "
    "w[i]);\n": "",
    "                ap[i] = __fadd_rn(ap[i], to_f32<T>(p[base + ch]));\n": ""}

# the approximate top-k: no 16-byte vectors (one element a lane or thread);
# the fused selection with the loads, bins and keys alone (every key folded
# into one per lane, the output read at a valid index)
_NO_VECTORS = {"    return n % vec == 0 && L % vec == 0":
               "    return false && n % vec == 0 && L % vec == 0"}
_SEL_NO_SELECTION = {
    "            const bool pass = kv[e] < th;\n":
    "            th = umin64(th, kv[e]);\n            continue;\n"
    "            const bool pass = kv[e] < th;\n",
    "            const unsigned i = (unsigned)list[r];\n":
    "            const unsigned i = (unsigned)(th ^ list[r]) % (unsigned)n;\n"}
# K1's way instead of the buffer: a round with `merge_min` or more keys
# below the threshold is merged at once, fewer are inserted one at a time
_SEL_WAIT = """            if (nw >= 32) {
                __syncwarp();
                const u64 v = wait[lane], rest = wait[lane + 32];
                __syncwarp();
                nw -= 32;
                if (lane < nw) wait[lane] = rest;
                merge<LL>(list, sort32(v, lane), lane);
                th = kth<LL>(list, kr, kl);
            }
"""


# the threshold tested on each winner's value and index before its key is
# built (only a winner that passes is keyed)
_SEL_VALUE_FILTER = {
    "    u64 th = ~0ull;\n":
    "    u64 th = ~0ull;\n    float thv = LARGEST ? -INFINITY : INFINITY;\n"
    "    unsigned thi = ~0u;\n",
    """        u64 kv[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
            kv[e] = m > 0 ? order_key<LARGEST>(
                                best[e], (unsigned)(b0 + e + jb[e] * L))
                          : ~0ull;
""": "",
    "            const bool pass = kv[e] < th;\n":
    """            const unsigned ie = (unsigned)(b0 + e + jb[e] * L);
            const float ve = best[e];
            const bool pass = m > 0 && ((LARGEST ? ve > thv : ve < thv) ||
                                        (ve == thv && ie < thi));
""",
    "            if (pass) wait[nw + __popc(ballot & below)] = kv[e];\n":
    "            if (pass)\n                wait[nw + __popc(ballot & below)] ="
    " order_key<LARGEST>(ve, ie);\n",
    "                th = kth<LL>(list, kr, kl);\n            }\n        }\n"
    "    }\n":
    """                th = kth<LL>(list, kr, kl);
                unsigned o = (unsigned)(th >> 32);
                if (LARGEST) o = ~o;
                thv = th == ~0ull ? (LARGEST ? -INFINITY : INFINITY)
                      : __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu)
                                                          : ~o);
                thi = (unsigned)th;
            }
        }
    }
"""}


def _sel_insert(merge_min: int) -> dict:
    return {"            if (pass) wait[nw + __popc(ballot & below)] = "
            "kv[e];\n            nw += __popc(ballot);\n" + _SEL_WAIT:
            f"""            unsigned pend = ballot;
            if (__popc(pend) >= {merge_min}) {{
                merge<LL>(list, sort32(pass ? kv[e] : ~0ull, lane), lane);
                th = kth<LL>(list, kr, kl);
                continue;
            }}
            while (pend) {{
                const int src = __ffs(pend) - 1;
                insert<LL>(list, shfl64(kv[e], src), lane);
                th = kth<LL>(list, kr, kl);
                pend &= ~(1u << src) & __ballot_sync(KNN_FULL, kv[e] < th);
            }}
"""}

# K4's histogram: P forced (the sweep's model of hist_parts is B * P about
# the SMs); an empty kernel; the loads alone
_HIST_P = "    const int p = sms / b;\n"


# the stream sums' finish with a full fence by every thread around each
# ticket (the first design) instead of acq_rel tickets
_ST_FENCES = {
    "    readers_sync();             // the block's row, before its ticket":
    "    __threadfence();\n    readers_sync();",
    "    if (!last) return;\n    if (tid == 0) cnt[grp] = 0;":
    "    if (!last) return;\n    __threadfence();\n"
    "    if (tid == 0) cnt[grp] = 0;",
    "        grow[c] = s;\n    }\n    readers_sync();":
    "        grow[c] = s;\n    }\n    __threadfence();\n    readers_sync();",
    "    if (!last) return;\n    if (tid == 0) cnt[groups] = 0;":
    "    if (!last) return;\n    __threadfence();\n"
    "    if (tid == 0) cnt[groups] = 0;"}
# stream_sum's units in balanced contiguous ranges (block b: units
# [units * b / blocks, units * (b + 1) / blocks), ST_UNROLL neighbouring
# units at a time; the first design) instead of dealt to the blocks in turn
_ST_RANGES = {
    "    const long long step = gridDim.x;\n"
    "    long long u = blockIdx.x;\n"
    "    for (; u + (ST_UNROLL - 1) * step < units; u += ST_UNROLL * step) {\n":
    "    const long long step = 1;\n"
    "    long long u = units * blockIdx.x / gridDim.x;\n"
    "    const long long end = units * (blockIdx.x + 1) / gridDim.x;\n"
    "    for (; u + ST_UNROLL <= end; u += ST_UNROLL) {\n",
    "    for (; u < units; u += step)\n": "    for (; u < end; ++u)\n"}


def _hist_p(p: int) -> dict:
    return {_HIST_P: f"    const int p = {p} + 0 * sms / b;\n"}


_HIST_THREADS = "#define HIST_THREADS 512 "
_HIST_EMPTY = {"    extern __shared__ int32_t hist_s[];\n":
               "    extern __shared__ int32_t hist_s[];\n    if (e >= 0) "
               "return;\n"}
_HIST_LOADS_ONLY = {"    if ((unsigned)t < (unsigned)n_rows) atomicAdd(h + t, "
                    "1);": "    if (t == 0x7fffffff) atomicAdd(h, n_rows);"}

VARIANTS = {
    "split": {
        "simple": ("depthwise.cu", _SIMPLE_ONLY),
        "simple_no_loads": ("depthwise.cu", {**_SIMPLE_ONLY, **_NO_LOADS}),
        "simple_loads_adds_only": ("depthwise.cu",
                                   {**_SIMPLE_ONLY, **_NO_PRODUCTS}),
        "copy_x_to_y": ("depthwise.cu", {**_SIMPLE_ONLY, **_COPY}),
        "gr": ("gather_reduce.cu", {}),
        "gr_loads_only": ("gather_reduce.cu", _gr_loads_only("w", 16)),
        "gr_simple": ("gather_reduce.cu", {}),
        "gr_simple_loads_only": ("gather_reduce.cu",
                                 _gr_loads_only("v", 20)),
        "k3": ("scatter.cu", {}),
        "k3_dense_only": ("scatter.cu", _K3_DENSE_ONLY),
        "k3_routing_only": ("scatter.cu", _K3_ROUTING_ONLY),
        "k3_simple": ("scatter.cu", _K3_SIMPLE),
        "k3_simple_dense_only": ("scatter.cu",
                                 {**_K3_SIMPLE, **_K3_DENSE_ONLY}),
        "k3_simple_routing_only": ("scatter.cu",
                                   {**_K3_SIMPLE, **_K3_ROUTING_ONLY}),
    },
    "dw": {name: ("depthwise.cu", edits) for name, edits in {
        "default": {},
        "stages_2": _tiles("32, 8, 16, 4, 2"),
        "stages_4": _tiles("32, 8, 16, 4, 4"),
        "tile_8x8": _tiles("32, 8, 8, 4, 3"),
        "tile_4x16_run2": _tiles("32, 4, 16, 2, 3"),
        "slice_16_tile_16x16": _tiles("16, 16, 16, 4, 3"),
        "slice_16_tile_8x16": _tiles("16, 8, 16, 4, 3"),
        "slice_64_tile_8x8": _tiles("64, 8, 8, 4, 3"),
        "no_d_split": {SPLIT_TARGET: "#define DW_TARGET_BLOCKS 1"},
        "d_split_528": {SPLIT_TARGET: "#define DW_TARGET_BLOCKS 528"},
        "d_split_2112": {SPLIT_TARGET: "#define DW_TARGET_BLOCKS 2112"},
    }.items()},
    "gr": {name: ("gather_reduce.cu", edits)
           for name, edits in {
        "default": {},
        "warps_16": {"    return WANT == 0 || (WANT == 1 && sizeof(T) == 4) ? 32":
                     "    return 16;\n    return WANT == 0 || (WANT == 1 && "
                     "sizeof(T) == 4) ? 32"},
        # the comparisons that propagate NaN on every step
        "nan_checks": {"        if (act && !far && !spec)\n":
                       "        if (act && !far && !spec && false)\n"},
        "unroll_8": {"#define GS_UNROLL 4 ": "#define GS_UNROLL 8 "},
        # every slot reads row 0: shared-memory reads without conflicts
        "abl_one_row": {"            const int r = rs[u];\n":
                        "            const int r = 0 * rs[u];\n"},
    }.items()},
    # the staged, the unstaged and the routed gather-reduce by batch size
    # (clouds x slices against the SMs), f32 "extrema" and "all" at (B,
    # 2048, 40, 64): one build, the routes forced
    "grb": {"default": ("gather_reduce.cu", {})},
    # the few-cloud route: the sharing schemes and the inner loop's steps
    "grc": {"multicast": ("gather_reduce.cu", {}),
            **{f"lanes_{lanes}": ("gather_reduce.cu", edits)
               for lanes, edits in _GRC_LANES.items()},
            "push": ("gather_reduce.cu", _GRC_PUSH),
            "peers": ("gather_reduce.cu", _GRC_PEERS),
            **{name: ("gather_reduce.cu", edits)
               for name, edits in _GRC_LOOP.items()},
            "abl_timeline": ("gather_reduce.cu", _GRC_TIMELINE),
            "abl_loads_only": ("gather_reduce.cu", _gr_loads_only("w", 16)),
            **{name: ("gather_reduce.cu", edits)
               for name, edits in _GRC_ABLATIONS.items()}},
    "k3": {name: ("scatter.cu", edits) for name, edits in {
        "default": {},
        "warps_16": {"#define RS_WARPS(T) (sizeof(T) == 4 ? 24 : 20)":
                     "#define RS_WARPS(T) 16"},
        "ids_2": {"#define RS_IDS 4 ": "#define RS_IDS 2 "},
        "ids_8": {"#define RS_IDS 4 ": "#define RS_IDS 8 "},
        # every edge reads node 0: shared-memory reads without conflicts
        "abl_one_node": {
            "                const int nd = (int)((e < m ? ns[e] : ns[0]) >> 8);\n":
            "                const int nd = 0 * (int)ns[e];\n"},
    }.items()},
    "k4": {name: ("scatter.cu", edits) for name, edits in {
        "default": {},
        "abl_empty": _HIST_EMPTY,
        "abl_loads_only": _HIST_LOADS_ONLY,
        "one_block_512": _hist_p(1),
        "one_block_1024": {**_hist_p(1),
                           _HIST_THREADS: "#define HIST_THREADS 1024 "},
        "p_2": _hist_p(2),
        "p_4": _hist_p(4),
        "p_8": _hist_p(8),
        "threads_256": {_HIST_THREADS: "#define HIST_THREADS 256 "},
        "threads_1024": {_HIST_THREADS: "#define HIST_THREADS 1024 "},
        "unroll_2": {"#define HIST_UNROLL 4 ": "#define HIST_UNROLL 2 "},
        "unroll_8": {"#define HIST_UNROLL 4 ": "#define HIST_UNROLL 8 "},
    }.items()},
    "sel": {name: ("approx_topk.cu", edits) for name, edits in {
        "default": {},
        "warps_4": {"#define SEL_WARPS 8 ": "#define SEL_WARPS 4 "},
        "warps_16": {"#define SEL_WARPS 8 ": "#define SEL_WARPS 16 "},
        "insert_each_merge_8": _sel_insert(8),
        "insert_each_merge_4": _sel_insert(4),
        "unroll_4": {"#define SEL_UNROLL 2 ": "#define SEL_UNROLL 4 "},
        "value_filter": _SEL_VALUE_FILTER,
        "min_blocks_3": {"__launch_bounds__(SEL_WARPS * 32)\nselect_rows(":
                         "__launch_bounds__(SEL_WARPS * 32, 3)\nselect_rows("},
        "min_blocks_4": {"__launch_bounds__(SEL_WARPS * 32)\nselect_rows(":
                         "__launch_bounds__(SEL_WARPS * 32, 4)\nselect_rows("},
        "no_vectors": _NO_VECTORS,
        "abl_no_selection": _SEL_NO_SELECTION,
    }.items()},
    "st": {name: ("stream.cu", edits) for name, edits in {
        "default": {},
        "unroll_4": {"#define ST_UNROLL 8 ": "#define ST_UNROLL 4 "},
        "unroll_16_blocks_2": {
            "#define ST_UNROLL 8 ": "#define ST_UNROLL 16 ",
            "#define ST_BLOCKS_PER_SM 4 ": "#define ST_BLOCKS_PER_SM 2 "},
        "blocks_2": {"#define ST_BLOCKS_PER_SM 4 ":
                     "#define ST_BLOCKS_PER_SM 2 "},
        "blocks_1": {"#define ST_BLOCKS_PER_SM 4 ":
                     "#define ST_BLOCKS_PER_SM 1 "},
        "ldcs": {"uint4 load_stream(const uint4* p, uint64_t pol) {\n":
                 "uint4 load_stream(const uint4* p, uint64_t pol) {\n"
                 "    return __ldcs(p);\n"},
        "copy_16k": {"#define ST_COPY (1 << 20)": "#define ST_COPY 16384"},
        "copy_4k": {"#define ST_COPY (1 << 20)": "#define ST_COPY 4096"},
        "ring_blocks_2": {"#define ST_ASYNC_BLOCKS_PER_SM 7 ":
                          "#define ST_ASYNC_BLOCKS_PER_SM 2 "},
        "group_4": {"#define ST_GROUP 16 ": "#define ST_GROUP 4 "},
        "group_64": {"#define ST_GROUP 16 ": "#define ST_GROUP 64 "},
        "fences": _ST_FENCES,
        "ranges": _ST_RANGES,
        "unroll_4_blocks_8": {
            "#define ST_UNROLL 8 ": "#define ST_UNROLL 4 ",
            "#define ST_BLOCKS_PER_SM 4 ": "#define ST_BLOCKS_PER_SM 8 "},
        "abl_no_finish": {
            "    finish_sums(part, cnt, out, total, l, tid);\n}\n\n"
            "__device__": "}\n\n__device__",
            "tid);\n    finish_sums(part, cnt, out, total, l, tid);\n}\n\n"
            "static": "tid);\n}\n\nstatic"},
    }.items()},
    "bins": {name: ("approx_topk.cu", edits) for name, edits in {
        "default": {},
        "no_vectors": _NO_VECTORS,
        "unroll_4": {"#define BIN_UNROLL 8 ": "#define BIN_UNROLL 4 "},
        "unroll_16": {"#define BIN_UNROLL 8 ": "#define BIN_UNROLL 16 "},
    }.items()},
    "tr": {name: ("scatter.cu", edits) for name, edits in {
        "default": {},
        "warps_2": {"#define TR_WARPS 4 ": "#define TR_WARPS 2 "},
        "warps_8": {"#define TR_WARPS 4 ": "#define TR_WARPS 8 "},
        "chunk_1024": {"#define TR_CHUNK 2048": "#define TR_CHUNK 1024"},
        "chunk_4096": {"#define TR_CHUNK 2048": "#define TR_CHUNK 4096"},
        "unroll_4": {"#define TR_UNROLL 8 ": "#define TR_UNROLL 4 "},
        "ballot_match": {  # one ballot a key bit for __match_any_sync
            "const unsigned peers = __match_any_sync(0xffffffffu, key[u]);":
            "unsigned peers = 0xffffffffu;\n            for (int i = 0; i <"
            " 32 - __clz(n_rows + 1); ++i) {\n                const bool "
            "bit = (key[u] + 1) >> i & 1;\n                const unsigned "
            "on = __ballot_sync(0xffffffffu, bit);\n                peers &="
            " bit ? on : ~on;\n            }"},
        "counters_in_device_memory": {"#define TR_SMEM (200 * 1024)":
                                      "#define TR_SMEM 0"},
    }.items()},
}

# a copy of the gather-reduce's bytes: the table read `reps` times through
# L2 (16-byte loads, coalesced), then `out16` 16-byte vectors written
_GR_COPY = r"""
__global__ void gr_copy_kernel(const uint4* __restrict__ a,
                               uint4* __restrict__ o, long long n16, int reps,
                               long long out16) {
    const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    const long long st = (long long)gridDim.x * blockDim.x;
    uint4 acc = make_uint4(0, 0, 0, 0);
    for (int r = 0; r < reps; ++r)
        for (long long i = t0; i < n16; i += st) {
            const uint4 v = __ldcg(a + i);
            acc.x ^= v.x; acc.y ^= v.y; acc.z ^= v.z; acc.w ^= v.w;
        }
    for (long long i = t0; i < out16; i += st) o[i] = acc;
}

extern "C" int gr_copy(const void* a, void* o, long long n16, int reps,
                       long long out16, void* stream) {
    gr_copy_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
        (const uint4*)a, (uint4*)o, n16, reps, out16);
    return (int)cudaGetLastError();
}

extern "C" int gr_clusters(int b, int n, int c, int want, int bf16,
                           int csize, int* fit) {
    return (int)(bf16 ? clusters_want<__nv_bfloat16>(want, b, n, c, csize,
                                                     fit)
                      : clusters_want<float>(want, b, n, c, csize, fit));
}
"""

# the transpose once more, with an event between its launches
_STAGES = r"""
extern "C" int tr_stages(const void* idx, void* cnt, void* deg, void* ptr,
                         void* order, int b, long long e, int n_rows,
                         float* ms) {
    const long long nj = tr_chunks(b, e, n_rows);
    const long long width = n_rows + 1;
    const long long fit = TR_SMEM / (width * 4);
    const int in_smem = fit >= 1;
    const int wpb = !in_smem ? TR_WARPS : fit < TR_WARPS ? (int)fit : TR_WARPS;
    const int smem = in_smem ? (int)(wpb * width * 4) : 0;
    cudaFuncSetAttribute(transpose_walk<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, TR_SMEM);
    cudaFuncSetAttribute(transpose_walk<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, TR_SMEM);
    cudaEvent_t ev[6];
    for (int i = 0; i < 6; ++i) cudaEventCreate(&ev[i]);
    const unsigned nb = (unsigned)((b * nj + wpb - 1) / wpb);
    const int32_t* ip = (const int32_t*)idx;
    int32_t *cp = (int32_t*)cnt, *dp = (int32_t*)deg, *pp = (int32_t*)ptr,
            *op = (int32_t*)order;
    cudaEventRecord(ev[0]);
    if (!in_smem) cudaMemsetAsync(cnt, 0, b * nj * width * 4);
    cudaEventRecord(ev[1]);
    transpose_walk<false><<<nb, wpb * 32, smem>>>(ip, cp, pp, op, b, e,
                                                  n_rows, nj, in_smem);
    cudaEventRecord(ev[2]);
    transpose_columns<<<(unsigned)((b * width + COUNT_THREADS - 1) /
                                   COUNT_THREADS), COUNT_THREADS>>>(
        cp, dp, b, n_rows, nj);
    cudaEventRecord(ev[3]);
    transpose_scan<<<b, SCAN_THREADS>>>(dp, pp, b, e, n_rows);
    cudaEventRecord(ev[4]);
    transpose_walk<true><<<nb, wpb * 32, smem>>>(ip, cp, pp, op, b, e,
                                                 n_rows, nj, in_smem);
    cudaEventRecord(ev[5]);
    cudaEventSynchronize(ev[5]);
    for (int i = 0; i < 5; ++i) cudaEventElapsedTime(&ms[i], ev[i], ev[i + 1]);
    for (int i = 0; i < 6; ++i) cudaEventDestroy(ev[i]);
    return (int)cudaGetLastError();
}
"""
STAGE_NAMES = ("memset", "count", "columns", "scan", "fill")

DW_SHAPES = (("b0", (1, 128, 128, 128, 32), torch.float32),
             ("b1", (1, 128, 128, 128, 96), torch.float32),
             ("b2b3", (1, 128, 128, 128, 144), torch.float32),
             ("b4", (1, 128, 128, 128, 192), torch.float32),
             ("b6", (1, 64, 64, 64, 192), torch.float32),
             ("b7", (1, 64, 64, 64, 384), torch.float32),
             ("b4_bf16", (1, 128, 128, 128, 192), torch.bfloat16))
STEP = (32, 2048, 40, 64)   # the DGCNN train step: B, N, k, C
VP, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def build(variants: dict, out_dir: str) -> dict:
    """{name: (source, edits)} -> {name: built library's path}; all nvcc
    runs start together, after every edit has been applied. An edit whose
    text is not in the source raises (before any nvcc starts)."""
    nvcc = _build._nvcc()
    paths = {}
    for name, (source, edits) in variants.items():
        with open(os.path.join(CSRC, source)) as f:
            src = f.read()
        for old, new in edits.items():
            if old not in src:
                raise ValueError(f"{name}: {old!r} not in {source}")
            src = src.replace(old, new)
        src += {"scatter.cu": _STAGES, "gather_reduce.cu": _GR_COPY}.get(
            source, "")
        paths[name] = os.path.join(out_dir, f"{name}.cu")
        with open(paths[name], "w") as f:
            f.write(src)
    procs = {}
    for name, path in paths.items():
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", CSRC, "-shared", "-o",
             os.path.join(out_dir, f"{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise _build.KernelBuildError(f"{name}: {err[-3000:]}")
    return {name: os.path.join(out_dir, f"{name}.so") for name in procs}


def time_depthwise(lib, inputs) -> dict:
    lib.fseg_depthwise_conv3.argtypes = [VP, VP, VP] + [I32] * 7 + [VP]
    row = {}
    for tag, x, w, want, check in inputs:
        y = torch.empty_like(x)

        def fn():
            return lib.fseg_depthwise_conv3(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), *x.shape, 1,
                int(x.dtype == torch.bfloat16), _stream())

        if fn() != 0:
            raise RuntimeError(f"{tag}: launch failed")
        torch.cuda.synchronize()
        if check and not torch.equal(y, want):
            raise AssertionError(f"{tag}: differs from plain")
        row[tag] = median_ms(fn)
    return row


def time_transpose(lib, idx, n) -> dict:
    b, e = idx.shape
    lib.fseg_transpose_scratch.restype = I64
    lib.fseg_transpose_scratch.argtypes = [I32, I64, I32]
    lib.fseg_graph_transpose.argtypes = [VP] * 5 + [I32, I64, I32, VP]
    lib.tr_stages.argtypes = [VP] * 5 + [I32, I64, I32, VP]
    dev = idx.device
    bufs = [torch.empty(lib.fseg_transpose_scratch(b, e, n),
                        dtype=torch.int32, device=dev),
            torch.empty(b * n + b, dtype=torch.int32, device=dev),
            torch.empty(b * n + b + 1, dtype=torch.int32, device=dev),
            torch.empty(b * e, dtype=torch.int32, device=dev)]
    ptrs = [t.data_ptr() for t in (idx, *bufs)]

    def fn():
        return lib.fseg_graph_transpose(*ptrs, b, e, n, _stream())

    if fn() != 0:
        raise RuntimeError("transpose: launch failed")
    order, ptr = ks.transpose_plain(idx, n)
    if not (torch.equal(bufs[3], order)
            and torch.equal(bufs[2][:b * n + 1], ptr)):
        raise AssertionError("transpose differs from plain")
    ms = (ctypes.c_float * 5)()
    runs = []
    for _ in range(7):
        lib.tr_stages(*ptrs, b, e, n, ctypes.cast(ms, VP))
        runs.append(list(ms))
    return {"transpose": median_ms(fn),
            **{s: statistics.median(r[i] for r in runs)
               for i, s in enumerate(STAGE_NAMES)}}


def split_k2(idx, n, c) -> dict:
    """K2's parts at the train step: the plain transpose's (the stable sort
    the wrapper ran before the transpose kernel), the kernel, the rows."""
    b = idx.shape[0]
    key = ks._flat_targets(idx, n)
    skey, _ = torch.sort(key, stable=True)
    rows = torch.arange(b * n + 1, device=idx.device, dtype=torch.int64)
    tr = ks.transpose(idx, n)
    out = {"plain_transpose": median_ms(lambda: ks.transpose_plain(idx, n)),
           "flat_targets": median_ms(lambda: ks._flat_targets(idx, n)),
           "stable_sort": median_ms(lambda: torch.sort(key, stable=True)),
           "searchsorted": median_ms(lambda: torch.searchsorted(skey, rows)),
           "transpose_kernel": median_ms(lambda: ks.transpose(idx, n))}
    gen = torch.Generator(device=idx.device).manual_seed(1)
    for dt in (torch.float32, torch.bfloat16):
        g = torch.randn((b, idx.shape[1], c), generator=gen,
                        device=idx.device).to(dt)
        name = str(dt).removeprefix("torch.")
        out[f"K2_{name}_own_transpose"] = median_ms(
            lambda: ks.scatter_rows(idx, g, n))
        out[f"K2_{name}_rows_only"] = median_ms(
            lambda: ks.scatter_rows(idx, g, n, tr))
    return out


def gr_cases(knn_cuda) -> list:
    """The gather-reduce's path calls: (tag, a, idx, want) — the train
    step's "all" in f32 and bf16 and P5's bf16 "max" on K1's graph at (32,
    2048, 40, 64), the served ensemble group's f32 "extrema" at (5, 2048,
    40, 64)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    out = []
    for b, calls in ((32, (("float32", "all"), ("bfloat16", "all"),
                           ("bfloat16", "max"))),
                     (5, (("float32", "extrema"),))):
        n, k, c = STEP[1:]
        pts = torch.rand((b, n, 3), generator=gen, device=dev) * 2 - 1
        idx = knn_cuda(pts, k)[0].contiguous()
        a = torch.randn((b, n, c), generator=gen, device=dev)
        for dt, want in calls:
            out.append((f"{b}x{n}x{k}x{c}_{dt}_{want}",
                        a.to(getattr(torch, dt)), idx, want))
    return out


def gr_batch_cases() -> list:
    """(tag, a, idx, want) at (B, 2048, 40, 64) f32 for B = 5 ... 32, random
    graphs: where the staged kernel's blocks split the points of a cloud
    slice (B x 4 slices < the SMs) against where they do not."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    n, k, c = STEP[1:]
    out = []
    for b in (5, 8, 11, 16, 22, 32):
        idx = torch.randint(0, n, (b, n, k), generator=gen, device=dev,
                            dtype=torch.int32)
        a = torch.randn((b, n, c), generator=gen, device=dev)
        out += [(f"{b}x{n}x{k}x{c}_float32_{want}", a, idx, want)
                for want in ("extrema", "all")]
    return out


# the few-cloud part: (B, 2048, 40, 64) "extrema" in f32 and bf16, random
# graphs; forced on the cluster route: one cluster a slice at each (lanes a
# point, cluster size) of GRC_LPP x GRC_PARTS, and at 64-byte slices
# GRC_CLUSTERS clusters a slice of GRC_PARTS_Q blocks each (16 at most)
GRC_BATCHES = (1, 2, 3, 5, 7, 9, 13, 14)
GRC_GRID = ("multicast", "lanes_2", "lanes_1")   # the builds with a grid
GRC_STAGED_PARTS = (1, 2, 3, 4, 5, 6, 8, 12, 16)
GRC_PARTS = (2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16)
GRC_CLUSTERS = (2, 3, 4)
GRC_PARTS_Q = (2, 3, 4, 5, 6, 8)


def grc_cases() -> list:
    """(tag, a, idx, "extrema") at (B, 2048, 40, 64) for GRC_BATCHES, f32 and
    bf16, and DPSR-Net's test ensembles (5 and 1 clouds of 1024, K = 20,
    f32)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    out = []
    shapes = [(b, *STEP[1:], dt) for b in GRC_BATCHES
              for dt in ("float32", "bfloat16")]
    shapes += [(5, 1024, 20, 64, "float32"), (1, 1024, 20, 64, "float32")]
    for b, n, k, c, dt in shapes:
        idx = torch.randint(0, n, (b, n, k), generator=gen, device=dev,
                            dtype=torch.int32)
        a = torch.randn((b, n, c), generator=gen, device=dev)
        out.append((f"{b}x{n}x{k}x{c}_{dt}_extrema", a.to(getattr(torch, dt)),
                    idx, "extrema"))
    return out


def _staged_parts(groups: int, sms: int, n: int) -> int:
    """csrc/gather_reduce.cu staged_parts: the staged route's split."""
    best, cost = 1, float("inf")
    for p in range(1, min((n + 127) // 128, 64) + 1):
        t = -(-groups * p // sms) * (1.0 + 40.0 / p)
        if t < cost - 1e-9:
            best, cost = p, t
    return best


def _route(lib, a, k, want, force):
    """(route, parts, cluster) of a call: the library's model, or `force`
    (ROUTE_UNSTAGED, ROUTE_STAGED or a tuple)."""
    from fissure_segmentation_tpu_torch.kernels.gather_reduce import WANTS
    b, n, c = a.shape
    bf16 = int(a.dtype == torch.bfloat16)
    if force == ROUTE_UNSTAGED:
        return 0, 0, 0
    if force == ROUTE_STAGED:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        return 1, _staged_parts(b * -(-c // (64 // a.element_size())), sms,
                                n), 1
    if force is not None:
        return force
    out = (ctypes.c_int * 3)()
    err = lib.fseg_gather_reduce_route(b, n, k, c, WANTS.index(want), bf16,
                                       out)
    if err != 0:
        raise RuntimeError(f"route query failed: cudaError_t {err}")
    return tuple(out)


def _gr_call(lib, a, idx, want, force=None):
    """(fn, outputs, route) of one gather-reduce call through the library."""
    from fissure_segmentation_tpu_torch.kernels.gather_reduce import WANTS
    lib.fseg_gather_reduce.argtypes = [VP] * 8 + [I32] * 9 + [VP]
    lib.fseg_gather_reduce_route.argtypes = [I32] * 6 + [
        ctypes.POINTER(I32)]
    b, n, c = a.shape
    k = idx.shape[-1]
    mode = WANTS.index(want)
    outs = [torch.empty_like(a)] + [torch.empty_like(a)] * (mode >= 1)
    if mode == 2:
        outs += [torch.empty((b, n, c), dtype=torch.int32,
                             device=a.device) for _ in range(2)]
        outs += [torch.empty((b, n, c), device=a.device) for _ in range(2)]
    ptrs = [t.data_ptr() for t in outs] + [None] * (6 - len(outs))
    r = _route(lib, a, k, want, force)
    bf16 = int(a.dtype == torch.bfloat16)

    def fn():
        return lib.fseg_gather_reduce(a.data_ptr(), idx.data_ptr(), *ptrs, b,
                                      n, k, c, mode, bf16, *r, _stream())
    return fn, outs, r


def _equal_plain(outs, a, idx, want, plain=None) -> bool:
    from fissure_segmentation_tpu_torch.kernels.gather_reduce import \
        gather_reduce_plain
    torch.cuda.synchronize()
    ref = plain if plain is not None else gather_reduce_plain(a, idx, want)
    return all(torch.equal(x, y) for x, y in zip(outs, ref))


def time_gr(lib, cases, check: bool, copy: bool = False,
            force=None) -> dict:
    """Each case through the library's fseg_gather_reduce on the model's
    route or `force`d onto one (checked equal to the plain version where
    `check`), and, where `copy`, the copy of the same bytes."""
    lib.gr_copy.argtypes = [VP, VP, I64, I32, I64, VP]
    row = {}
    for tag, a, idx, want in cases:
        fn, outs, _ = _gr_call(lib, a, idx, want, force)
        if fn() != 0:
            raise RuntimeError(f"{tag}: launch failed")
        if check and not _equal_plain(outs, a, idx, want):
            raise AssertionError(f"gather_reduce {tag}: differs from plain")
        row[tag] = median_ms(fn)
        if not copy:
            continue
        k = idx.shape[-1]
        out_bytes = sum(t.numel() * t.element_size() for t in outs)
        sink = torch.empty(out_bytes // 16 * 16, dtype=torch.uint8,
                           device=a.device)
        row[f"{tag}_copy"] = median_ms(lambda: lib.gr_copy(
            a.data_ptr(), sink.data_ptr(), a.numel() * a.element_size() // 16,
            k, out_bytes // 16, _stream()))
    return row


def time_grb(lib) -> dict:
    """The batch sweep: each case on the staged route (the uncapped split),
    the unstaged kernel and the model's route, each equal to plain."""
    cases = gr_batch_cases()
    return {name: time_gr(lib, cases, True, force=force)
            for name, force in (("staged", ROUTE_STAGED),
                                ("unstaged", ROUTE_UNSTAGED),
                                ("routed", None))}


def _sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def _timeline(lib, fn, blocks: int) -> dict:
    """One call of the abl_timeline build: each phase's end (GRC_PHASES)
    after the kernel's first block entered, us: the median and the last
    block; and the last block's entry."""
    lib.gc_timeline.argtypes = [VP, I32]
    fn()
    torch.cuda.synchronize()
    t = torch.empty((blocks, 8), dtype=torch.int64)
    if lib.gc_timeline(t.data_ptr(), blocks) != 0:
        raise RuntimeError("timeline copy failed")
    t = (t - t[:, 0].min()).double() / 1e3
    out = {"entry_last": t[:, 0].max().item()}
    for i, name in enumerate(GRC_PHASES, 1):
        if name == "slice" and not bool((t[:, 2] > 0).any()):
            continue   # no cluster: no exchange
        out[f"{name}_median"] = t[:, i].median().item()
        out[f"{name}_last"] = t[:, i].max().item()
    return out


def _grid_key(tag: str, r) -> str:
    if r[0] == 1:
        return f"{tag}_staged_p{r[1]}"
    return f"{tag}_p{r[2]}_q{r[1] // r[2]}"


def _clusters(lib, a, want) -> dict:
    """{cluster size: clusters of it that fit on the card at once} for the
    cluster route's kernel at a's shape (the model's waves)."""
    from fissure_segmentation_tpu_torch.kernels.gather_reduce import WANTS
    lib.gr_clusters.argtypes = [I32] * 6 + [ctypes.POINTER(I32)]
    b, n, c = a.shape
    out, fit = {}, I32()
    for p in range(2, 17):
        err = lib.gr_clusters(b, n, c, WANTS.index(want),
                              int(a.dtype == torch.bfloat16), p,
                              ctypes.byref(fit))
        out[p] = fit.value if err == 0 else f"cudaError_t {err}"
    return out


def time_grc(lib, cases, grid: bool, check: bool = True,
             timeline: bool = False) -> dict:
    """The few-cloud calls on the card alone (`graph_ms`): on the model's
    route (its (route, parts, cluster) recorded, and its issue slots a
    lane-value: ms x the SM clock x 4 schedulers x 32 lanes x the SMs /
    B N K C, at the card's top SM clock), on the unstaged kernel and on the
    staged kernel forced to each of GRC_STAGED_PARTS blocks a slice (keyed
    "_staged_p{parts}"), with the clusters of each size that fit on the card
    ("_fit"); where `grid`, at every forced cluster shape of GRC_PARTS (one
    cluster a slice) and of GRC_CLUSTERS x GRC_PARTS_Q whose clusters fit
    on the card, each keyed "_p{cluster}_q{clusters a slice}"; every
    route's outputs equal to plain where `check`; where `timeline`, the
    model's route's block timeline instead (`_timeline`). A build whose
    route query fails records the error."""
    from fissure_segmentation_tpu_torch.kernels.gather_reduce import \
        gather_reduce_plain
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = _sm_clock_mhz()
    row = {"sm_clock_mhz": mhz}
    for tag, a, idx, want in cases:
        plain = gather_reduce_plain(a, idx, want) if check else None
        forces = [None]
        if not timeline:
            row[f"{tag}_fit"] = _clusters(lib, a, want)
            forces += [ROUTE_UNSTAGED] + [(1, p, 1)
                                          for p in GRC_STAGED_PARTS]
        if grid:
            forces += [(2, p, p) for p in GRC_PARTS]
            forces += [(2, q * p, p) for q in GRC_CLUSTERS
                       for p in GRC_PARTS_Q if q * p <= 16]
        for force in forces:
            try:
                fn, outs, r = _gr_call(lib, a, idx, want, force)
            except RuntimeError as exc:
                row[f"{tag}_route"] = str(exc)
                break
            err = fn()
            if err != 0 and force not in (None, ROUTE_UNSTAGED):
                row[_grid_key(tag, r)] = f"cudaError_t {err}"
                continue
            if err != 0:
                raise RuntimeError(f"{tag} {r}: launch failed: {err}")
            if check and not _equal_plain(outs, a, idx, want, plain):
                raise AssertionError(f"gather_reduce {tag} {r}: differs "
                                     "from plain")
            b, n, c = a.shape
            if timeline:
                row[f"{tag}_route"] = list(r)
                row[f"{tag}_timeline"] = _timeline(
                    lib, fn, b * -(-c // (64 // a.element_size()))
                    * max(r[1], 1))
                continue
            ms = graph_ms(fn)
            if force is None:
                row[f"{tag}_route"] = list(r)
                row[tag] = ms
                row[f"{tag}_slots_a_lane_value"] = (
                    ms * 1e-3 * mhz * 1e6 * 4 * 32 * sms
                    / (b * n * idx.shape[-1] * c))
            elif force == ROUTE_UNSTAGED:
                row[f"{tag}_unstaged"] = ms
            else:
                row[_grid_key(tag, r)] = ms
    return row


def time_k3(lib, idx, check: bool) -> dict:
    """K3 through the library's fseg_scatter_routed at the train step, f32
    and bf16 payloads, given the step's shared transpose (checked equal to
    the package's kernel where `check`)."""
    lib.fseg_scatter_routed.argtypes = [VP] * 6 + [I32] * 6 + [VP]
    b, n, k, c = STEP
    idx3 = idx.reshape(b, n, k)
    order, ptr = ks.transpose(idx, n)
    gen = torch.Generator(device=idx.device).manual_seed(3)
    kstar = torch.randint(0, k, (b, n, c), generator=gen, device=idx.device,
                          dtype=torch.int32)
    row = {}
    for dt in (torch.float32, torch.bfloat16):
        s = torch.randn((b, n, c), generator=gen, device=idx.device).to(dt)
        p = torch.randn((b, n, c), generator=gen, device=idx.device).to(dt)
        out = torch.empty((b, n, 2 * c), device=idx.device)

        def fn():
            return lib.fseg_scatter_routed(
                kstar.data_ptr(), s.data_ptr(), p.data_ptr(),
                order.data_ptr(), ptr.data_ptr(), out.data_ptr(), b, n, n, k,
                c, int(dt == torch.bfloat16), _stream())

        if fn() != 0:
            raise RuntimeError("K3: launch failed")
        torch.cuda.synchronize()
        if check and not torch.equal(
                out, ks.scatter_routed(idx3, kstar, s, p, n, (order, ptr))):
            raise AssertionError("K3 differs from the package's kernel")
        row[f"K3_{b}x{n}x{k}x{c}_{str(dt)[6:]}"] = median_ms(fn)
    return row


def k4_cases() -> list:
    """(tag, idx, n_rows): the train step's graph size at 2048 rows, P1's
    512 rows (idx mod 512), and 2048 rows at B = 1 ... 16, E = 81 920, on
    uniform targets."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    e = STEP[1] * STEP[2]
    out = []
    for b in (32, 16, 8, 4, 1):
        idx = torch.randint(0, 2048, (b, e), generator=gen, device=dev,
                            dtype=torch.int32)
        out.append((f"{b}x{e}_rows2048", idx, 2048))
        if b == 32:
            out.append((f"{b}x{e}_rows512", idx % 512, 512))
    return out


def time_k4(lib, cases, check: bool) -> dict:
    """K4's histogram through the library's fseg_scatter_count (checked
    equal to plain where `check`), its work on the card (`graph_ms`: one
    launch is shorter than a ctypes call); with `check`, also the
    in-degrees from the transpose (fseg_count_from_ptr) at each case."""
    lib.fseg_scatter_count.argtypes = [VP, VP, VP, I32, I64, I32, VP]
    lib.fseg_count_from_ptr.argtypes = [VP, VP, I64, VP]
    row = {}
    for tag, idx, n in cases:
        b, e = idx.shape
        out = torch.empty((b, n), device=idx.device)

        def fn():
            if lib.fseg_scatter_count(idx.data_ptr(), None, out.data_ptr(),
                                      b, e, n, _stream()) != 0:
                raise RuntimeError(f"K4 {tag}: launch failed")

        fn()
        torch.cuda.synchronize()
        if check and not torch.equal(out, ks.scatter_count_plain(idx, n)):
            raise AssertionError(f"K4 {tag}: differs from plain")
        row[tag] = graph_ms(fn)
        if not check:
            continue
        ptr = ks.transpose(idx, n)[1]

        def from_ptr():
            if lib.fseg_count_from_ptr(ptr.data_ptr(), out.data_ptr(), b * n,
                                       _stream()) != 0:
                raise RuntimeError(f"K4 {tag}: launch failed")

        from_ptr()
        torch.cuda.synchronize()
        if not torch.equal(out, ks.scatter_count_plain(idx, n)):
            raise AssertionError(f"K4 from ptr {tag}: differs from plain")
        row[f"{tag}_from_ptr"] = graph_ms(from_ptr)
    return row


def sel_cases() -> list:
    """(tag, x (rows, n), L, R, k, largest, idx64, plain result): the kNN
    rows of the --knn_recall step (coordinate distances f32 with the
    diagonal at +inf, bf16 feature distances with it at -1; L = 512 x 4,
    k = 40), the exact feature graph (bf16, diagonal 0, L = n, kk = 41,
    int32 indices) and the fast-serving static graph's rows (5 clouds of
    2048, f32)."""
    from fissure_segmentation_tpu_torch.kernels.approx_topk import \
        select_rows_plain
    from fissure_segmentation_tpu_torch.ops.knn import pairwise_sqdist
    gen = torch.Generator(device="cuda").manual_seed(18)
    pts = torch.rand((32, 2048, 3), generator=gen, device="cuda")
    coords = pairwise_sqdist(pts, pts)
    coords.diagonal(dim1=-2, dim2=-1).fill_(torch.inf)
    feats = torch.randn((32, 2048, 64), generator=gen, device="cuda").to(
        torch.bfloat16)
    fd = pairwise_sqdist(feats, feats)
    fd.diagonal(dim1=-2, dim2=-1).fill_(-1.0)
    exact = pairwise_sqdist(feats)
    out = []
    for tag, d, n_bins, red, k, idx64 in (
            ("knn_rows_f32", coords, 512, 4, 40, 1),
            ("knn_rows_bf16", fd, 512, 4, 40, 1),
            ("feature_graph_bf16_k41", exact, 2048, 1, 41, 0),
            ("static_10240x2048_f32", coords[:5], 512, 4, 40, 1)):
        x = d.reshape(-1, 2048)
        out.append((tag, x, n_bins, red, k, False, idx64,
                    select_rows_plain(x, n_bins, red, k, False)))
    return out


def time_sel(lib, cases, check: bool) -> dict:
    """The fused row selection through the library's fseg_select_rows at
    each case (equal to plain, values and indices, where `check`)."""
    lib.fseg_select_rows.argtypes = [VP, VP, VP, I64, I64, I64, I32, I32,
                                     I32, I32, I32, VP]
    row = {}
    for tag, x, n_bins, red, k, largest, idx64, (vp, ip) in cases:
        rows, n = x.shape
        vals = torch.empty((rows, k), dtype=x.dtype, device=x.device)
        idx = torch.empty((rows, k), device=x.device,
                          dtype=torch.int64 if idx64 else torch.int32)

        def fn():
            if lib.fseg_select_rows(
                    x.data_ptr(), vals.data_ptr(), idx.data_ptr(), rows, n,
                    n_bins, red, k, int(largest),
                    int(x.dtype == torch.bfloat16), idx64, _stream()) != 0:
                raise RuntimeError(f"select_rows {tag}: launch failed")

        fn()
        torch.cuda.synchronize()
        if check and not (torch.equal(vals, vp)
                          and torch.equal(idx.long(), ip)):
            raise AssertionError(f"select_rows {tag}: differs from plain")
        row[tag] = median_ms(fn)
    return row


def bins_cases() -> list:
    """(tag, x (1, 256^3), L, R, plain result): the detectors' uniform
    scores in f32 and bf16, L = 524 288, R = 32."""
    from fissure_segmentation_tpu_torch.kernels.approx_topk import \
        bin_extrema_plain
    gen = torch.Generator(device="cuda").manual_seed(19)
    x = torch.rand((1, 256 ** 3), generator=gen, device="cuda")
    return [(f"detector_256cube_{str(dt)[6:]}", x.to(dt), 524_288, 32,
             bin_extrema_plain(x.to(dt), 524_288, 32, True))
            for dt in (torch.float32, torch.bfloat16)]


def time_bins(lib, cases, check: bool) -> dict:
    """The bin pass through the library's fseg_bin_extrema (equal to plain
    where `check`), cold and warm."""
    lib.fseg_bin_extrema.argtypes = [VP, VP, VP, I64, I64, I64, I32, I32,
                                     I32, VP]
    row = {}
    for tag, x, n_bins, red, (vp, ip) in cases:
        rows, n = x.shape
        vals = torch.empty((rows, n_bins), dtype=x.dtype, device=x.device)
        idx = torch.empty((rows, n_bins), dtype=torch.int32, device=x.device)

        def fn():
            if lib.fseg_bin_extrema(x.data_ptr(), vals.data_ptr(),
                                    idx.data_ptr(), rows, n, n_bins, red, 1,
                                    int(x.dtype == torch.bfloat16),
                                    _stream()) != 0:
                raise RuntimeError(f"bin_extrema {tag}: launch failed")

        fn()
        torch.cuda.synchronize()
        if check and not (torch.equal(vals, vp) and torch.equal(idx, ip)):
            raise AssertionError(f"bin_extrema {tag}: differs from plain")
        row[f"{tag}_cold"] = cold_ms(fn)
        row[f"{tag}_warm"] = median_ms(fn)
    return row


def st_cases() -> list:
    """(tag, g2d, chunk, nbuf, plain sums of its integer payload, that
    payload, the payload with a tile zeroed): P1's (2 621 440, 64) bf16
    view and its float32 copy for stream_sum; P3's (1 310 720, 128) view
    at the probes' ASYNC_GRID for the ring."""
    from fissure_segmentation_tpu_torch.kernels.stream import (
        exact_payload, stream_sum_plain)
    from fissure_segmentation_tpu_torch.prof.probes import (ASYNC_GRID,
                                                            payload)
    g = payload()[1]
    views = [("p1_2621440x64_bf16", g.view(-1, 64), None, None),
             ("p4_2621440x64_f32", g.view(-1, 64).float(), None, None)] + [
        (f"p3_1310720x128_bf16_c{c}_b{b}", g.view(-1, 128), c, b)
        for c, b in ASYNC_GRID]
    out, ints = [], {}
    for tag, v, c, b in views:
        key = (tuple(v.shape), v.dtype)
        if key not in ints:
            x = exact_payload(v)
            bad = x.clone()
            bad[x.shape[0] // 2:x.shape[0] // 2 + 256] = 0
            ints[key] = (stream_sum_plain(x), x, bad)
        out.append((tag, v, c, b, *ints[key]))
    return out


def time_st(lib, cases, check: bool) -> dict:
    """Each stream variant at `cases` through the scratch library's own
    occupancy query and entry points (equal to plain on the integer
    payload and unequal with a tile zeroed, where `check`), CUDA events."""
    lib.fseg_stream_occupancy.argtypes = [I32] * 4
    lib.fseg_stream_sum.argtypes = [VP] * 5 + [I64, I32, I32, I32, VP]
    lib.fseg_stream_sum_async.argtypes = [VP] * 5 + [I64] + [I32] * 5 + [VP]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cnt = torch.zeros(256, dtype=torch.int32, device="cuda")
    row = {}
    for tag, v, chunk, nbuf, want, ints, bad in cases:
        rows, lanes = v.shape
        bf16 = int(v.dtype == torch.bfloat16)
        per_sm = lib.fseg_stream_occupancy(lanes, bf16, chunk or 0, nbuf or 0)
        work = (max(1, v.numel() * v.element_size() // 16 // 256)
                if chunk is None else -(-rows // chunk))
        blocks = min(per_sm * sms, work)
        part = torch.empty((2 * blocks, lanes), device="cuda")
        out = torch.empty(lanes, device="cuda")

        def fn(x=v):
            if chunk is None:
                err = lib.fseg_stream_sum(
                    x.data_ptr(), part.data_ptr(), cnt.data_ptr(),
                    out.data_ptr(), None, rows, lanes, bf16, blocks,
                    _stream())
            else:
                err = lib.fseg_stream_sum_async(
                    x.data_ptr(), part.data_ptr(), cnt.data_ptr(),
                    out.data_ptr(), None, rows, lanes, bf16, chunk, nbuf,
                    blocks, _stream())
            if err != 0:
                raise RuntimeError(f"stream {tag}: launch failed ({err})")
            return out

        if check:
            if not torch.equal(fn(ints).clone(), want):
                raise AssertionError(f"stream {tag}: differs from plain")
            if torch.equal(fn(bad), want):
                raise AssertionError(f"stream {tag}: a zeroed tile unseen")
        row[tag] = median_ms(fn)
        row[f"{tag}_blocks"] = blocks
    return row


def _one(full: str, out_dir: str, grid: bool) -> dict:
    """Time one built variant (`full`: part_name) in a child process of
    this script (--one); its result line."""
    cmd = [sys.executable, os.path.abspath(__file__), "--one", full,
           "--build", out_dir] + ([] if grid else ["--no_grid"])
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
    for line in res.stdout.splitlines():
        if line.startswith(full + " "):
            return json.loads(line.split(" ", 1)[1])
    raise RuntimeError(f"{full}: rc {res.returncode}\n{res.stderr[-3000:]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts",
                    default="split,dw,tr,gr,grb,grc,k3,k4,sel,bins,st")
    ap.add_argument("--build", default=None)
    ap.add_argument("--no_grid", action="store_true",
                    help="grc: the model's route alone, no forced grid")
    ap.add_argument("--only", default=None,
                    help="comma-separated variant names to build and time")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("design_sweep runs only on an NVIDIA card")
    parts = args.parts.split(",")
    grid_grc = not args.no_grid
    out_dir = args.build or tempfile.mkdtemp()
    os.makedirs(out_dir, exist_ok=True)
    only = args.only.split(",") if args.only else None
    todo = {f"{part}_{name}": variant for part in parts
            for name, variant in VARIANTS[part].items()
            if only is None or name in only}
    if args.one:   # a gather-reduce build of the parent's, alone
        parts = [args.one.split("_", 1)[0]]
        paths = {args.one: os.path.join(out_dir, f"{args.one}.so")}
    else:
        paths = build(todo, out_dir)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = []
    if {"split", "dw"} & set(parts) and not args.one:
        for tag, shape, dt in DW_SHAPES:
            x = torch.randn(shape, generator=gen, device=dev).to(dt)
            w = torch.randn((3, 3, 3, shape[-1]), generator=gen,
                            device=dev).to(dt)
            inputs.append((tag, x, w, depthwise_conv3_plain(x, w)))
    b, n, k, c = STEP
    idx = torch.randint(0, n, (b, n * k), generator=gen, device=dev,
                        dtype=torch.int32)
    grs = gr_cases(knn_cuda) if {"split", "gr"} & set(parts) else []
    k4s = k4_cases() if "k4" in parts else []
    grcs = grc_cases() if "grc" in parts else []
    sels = sel_cases() if "sel" in parts else []
    bins = bins_cases() if "bins" in parts else []
    sts = st_cases() if "st" in parts else []
    res = {part: {} for part in parts}
    for full, path in paths.items():
        part, name = full.split("_", 1)
        source = VARIANTS[part][name][0]
        if source == "gather_reduce.cu" and not args.one:
            # each build of the gather-reduce in a process of its own: in
            # one process a second such library's cluster queries fail
            # (cudaErrorInvalidClusterSize, 912)
            res[part][name] = _one(full, out_dir, grid_grc)
            print(full, json.dumps(res[part][name]), flush=True)
            continue
        lib = ctypes.CDLL(path)
        # the split's ablations and the abl_ variants compute something
        # else: not checked
        whole = (part != "split" or name in ("gr", "gr_simple", "k3",
                                             "k3_simple")) \
            and not name.startswith("abl_")
        if part == "st":
            res[part][name] = time_st(lib, sts, whole)
        elif part == "sel":
            res[part][name] = time_sel(lib, sels, whole)
        elif part == "bins":
            res[part][name] = time_bins(lib, bins, whole)
        elif part == "tr":
            res[part][name] = time_transpose(lib, idx, n)
        elif part == "k4":
            res[part][name] = time_k4(lib, k4s, whole)
        elif part == "grb":
            res[part][name] = time_grb(lib)
        elif part == "grc":
            res[part][name] = time_grc(
                lib, grcs, name in GRC_GRID and grid_grc,
                check=not name.startswith("abl_"),
                timeline=name == "abl_timeline")
        elif source == "gather_reduce.cu":
            res[part][name] = time_gr(
                lib, grs, whole, copy=part == "split" and name == "gr",
                force=ROUTE_UNSTAGED if name.startswith("gr_simple") else None)
        elif source == "scatter.cu":
            res[part][name] = time_k3(lib, idx, whole)
        else:   # the ablations compute something else: not checked
            check = part == "dw" or name == "simple"
            res[part][name] = time_depthwise(
                lib, [(*inp, check) for inp in inputs])
        print(full, json.dumps(res[part][name]), flush=True)
    if "split" in parts and not args.one:
        res["split"]["K2"] = split_k2(idx, n, c)
    print(json.dumps(res), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60)
    print(card.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()

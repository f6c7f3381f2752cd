// The B-spline stencil of a particle, recomputed from its position, and a
// thread block's shared-memory window over the grid nodes that its particles
// touch. Shared by fused_apply.cu and fused_linearize.cu.
//
// Stencil, as hot_tpu_torch/ops/transfer.py:particle_stencil computes it, W
// nodes per axis (W = 3 quadratic, W = 4 cubic): per axis the base node
// (floor(x/dx - 0.5) quadratic, floor(x/dx) - 1 cubic) and u = x/dx - base,
// the W weights and weight derivatives of ops/bspline.py, node coordinates
// base + {0 .. W-1} clamped to [0, res - 1] (a boundary particle repeats a
// node, and its contributions to that node add up, as index_add_ adds them).
// The weight gradient of node (i, j, k) has the association ((dw_x w_y) w_z)
// of bspline.tensor_weights. Node ids are row-major, the last axis
// contiguous. The width is a template parameter: the quadratic and cubic
// kernels are separate instances.
//
// Node addressing: the dense grid's row-major ids, or, with a tile lookup
// (Grid::lookup, grid/sparse.py), the compact ids of the sparse tile grid:
// a node in logical tile t at local position l (row-major inside the tile,
// the last axis contiguous) lives at lookup[t] * tile^D + l, and lookup[t]
// is -1 for an inactive tile. The window and the stencil stay in logical
// node coordinates; the lookup applies only where a logical node becomes a
// global address. A box node in an inactive tile reads 0 and is never
// written (a particle's own stencil nodes are always in active tiles:
// activation takes every tile of every stencil). Along the last axis a box
// row is contiguous in memory only within a tile's run of `tile` nodes, so
// the box load and flush take a run per thread and look its slot up once.
// Tile-grid addressing is a template parameter (Tiled) of the frame and the
// kernels: the dense instances compile to the code they had without it. A
// batch's tile grid has one lookup per member, `tiles` entries each, one
// after another: a block offsets the lookup to its member's
// (Grid::for_member), as it offsets its member's arrays.
//
// Window: a block takes consecutive particles. Seeded in lattice order they
// lie in a few cells, so the block reduces its particles' bases to a node box
// (min base to max base + W - 1 per axis) and loads the grid vector over the box
// into shared memory (one warp per row along the contiguous last axis); each
// particle gathers from there. The scatter is a counting sort by node, with
// no shared-memory float atomics (on Hopper those are compare-and-swap
// loops, and 81 of them one after another per 3D particle left the kernel
// waiting on shared-memory latency):
//   1. each particle counts itself at its W^d nodes with integer atomics
//      (native on Hopper);
//   2. an exclusive scan of the counts gives each node a contiguous run of
//      slots, and a copy of the run starts serves as cursors;
//   3. each particle takes a slot at each node from the cursor (an integer
//      atomic) and stores its contribution there;
//   4. each node's run is summed, and every non-zero sum goes to the grid
//      with one global atomicAdd.
//
// A particle whose stencil is clamped at the grid's edge, and every particle
// of a block whose box holds more than `window_nodes` nodes (a scrambled or
// far-deformed order), gathers from and scatters into global memory directly
// (W^d d atomics per particle: 81 quadratic and 192 cubic in 3D). The branch
// is uniform over a block except
// for the clamped particles.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>

#include "small_mat.cuh"

namespace hot {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 256;
// the most members of a batched launch (gridDim.y)
constexpr int kMaxBatch = 65535;

// The element offset of this block's member (blockIdx.y) in an array of
// `per_member` elements per member, in 64 bits.
__device__ __forceinline__ long long member_offset(long long per_member) {
  return (long long)blockIdx.y * per_member;
}

// Counters a kernel adds to when the caller passes a buffer of kStatCount
// uint64 (hot_tpu_torch/ops/fused_apply.py:STATS names them).
enum WindowStat {
  kStatBlocks = 0,    // blocks launched
  kStatOverflow = 1,  // blocks that took the global-memory path
  kStatNodes = 2,     // sum over blocks of the box's node count
  kStatMaxNodes = 3,  // the largest box
  kStatAtomics = 4,   // global atomicAdds issued
  kStatHist = 5,      // kStatHist + b: blocks whose box has [2^b, 2^(b+1)) nodes
  kStatCount = kStatHist + 24,
};

template <int D>
struct Grid {
  int res[D];
  // tile grid (nullptr: the dense grid): logical tile -> slot, -1 inactive;
  // tile nodes per axis, tile^D, and the row-major strides of the tiles
  const int* lookup;
  int tile, tile_nodes;
  int tile_stride[D];
  long long tiles;  // logical tiles: the entries of one member's lookup

  // This block's member's grid: its own lookup on a batch's tile grid.
  __device__ __forceinline__ Grid for_member() const {
    Grid g = *this;
    if (lookup != nullptr) g.lookup += member_offset(tiles);
    return g;
  }
};

// A grid from the C interface's arguments (lookup may be null).
template <int D>
inline Grid<D> make_grid(const int* res, const int* lookup, int tile) {
  Grid<D> g;
  g.lookup = lookup;
  g.tile = lookup != nullptr ? tile : 1;
  g.tile_nodes = 1;
  int stride = 1;
  for (int a = D - 1; a >= 0; --a) {
    g.res[a] = res[a];
    g.tile_stride[a] = stride;
    stride *= (res[a] + g.tile - 1) / g.tile;
    g.tile_nodes *= g.tile;
  }
  g.tiles = stride;
  return g;
}

// Node index -> address. In the window and on the dense grid the index is
// the address (Local); on the tile grid's direct (global-memory) path
// node_offsets makes the index tile id * tile^D + local id, and NodeMap
// turns it into the compact address, -1 for an inactive tile.
struct Local {
  static constexpr bool kMayMiss = false;
  __device__ __forceinline__ int operator()(int node) const { return node; }
};
struct NodeMap {
  static constexpr bool kMayMiss = true;
  const int* lookup;
  int tile_nodes;
  __device__ __forceinline__ int operator()(int node) const {
    const int slot = lookup[node / tile_nodes];
    return slot < 0 ? -1 : slot * tile_nodes + node % tile_nodes;
  }
};

template <int D, int W>
struct StencilSize {
  static constexpr int value = W * StencilSize<D - 1, W>::value;
};
template <int W>
struct StencilSize<0, W> {
  static constexpr int value = 1;
};

template <typename T, int D, int W>
struct Stencil {
  static constexpr int S = StencilSize<D, W>::value;  // nodes
  T w[D][W], dw[D][W];
  int c[D][W];  // clamped node coordinate per axis and offset
};

template <int D>
struct Window {
  int lo[D], ext[D];
  int nodes;
  bool fits;
};

// Shared memory a launch reserves, for a box of at most window_nodes nodes
// and a block of `threads` particles:
//   T   win[window_nodes * D]    the grid vector over the box
//   T   slots[threads * W^D * D] the contributions, sorted by node
//   int start[window_nodes + 1]  counts per node, then each node's first slot
//   int cursor[window_nodes + 1] each node's next free slot
//   int scan[threads / 32]       the scan's warp totals
template <typename T, int D, int W>
size_t window_bytes(int window_nodes, int threads) {
  constexpr int S = StencilSize<D, W>::value;
  return ((size_t)window_nodes * D + (size_t)threads * S * D) * sizeof(T) +
         (2 * ((size_t)window_nodes + 1) + threads / kWarp) * sizeof(int);
}

template <typename T, int D>
struct Shared {
  T* win;
  T* slots;
  int* start;
  int* cursor;
  int* scan;
};

template <typename T, int D, int W>
__device__ __forceinline__ Shared<T, D> carve(unsigned char* smem, int window_nodes) {
  constexpr int S = StencilSize<D, W>::value;
  Shared<T, D> sh;
  sh.win = reinterpret_cast<T*>(smem);
  sh.slots = sh.win + (size_t)window_nodes * D;
  sh.start = reinterpret_cast<int*>(sh.slots + (size_t)blockDim.x * S * D);
  sh.cursor = sh.start + window_nodes + 1;
  sh.scan = sh.cursor + window_nodes + 1;
  return sh;
}

// The cubic B-spline's outer (1 <= |t| < 2) and inner (|t| < 1) pieces of
// N(t) and dN/dt at a = |t|, as ops/bspline.py:cubic_kernel_1d has them.
template <typename T>
__device__ __forceinline__ T cubic_outer(T a) {
  return -(a * a * a) / T(6) + a * a - T(2) * a + T(4) / T(3);
}
template <typename T>
__device__ __forceinline__ T cubic_inner(T a) {
  return T(0.5) * (a * a * a) - a * a + T(2) / T(3);
}
template <typename T>
__device__ __forceinline__ T cubic_outer_grad(T a) {
  return T(-0.5) * a * a + T(2) * a - T(2);
}

template <typename T, int D, int W>
__device__ __forceinline__ void stencil_of(const T* __restrict__ x, long long n, long long p,
                                           T dx, const Grid<D>& g, Stencil<T, D, W>& s) {
  static_assert(W == 3 || W == 4, "quadratic (3) or cubic (4) stencils");
#pragma unroll
  for (int a = 0; a < D; ++a) {
    const T xs = x[a * n + p] / dx;
    T b;
    if constexpr (W == 3) {
      b = floor_(xs - T(0.5));
      const T u = xs - b;
      const T t0 = T(1.5) - u, t1 = u - T(1), t2 = T(1.5) + (u - T(2));
      s.w[a][0] = T(0.5) * (t0 * t0);
      s.w[a][1] = T(0.75) - t1 * t1;
      s.w[a][2] = T(0.5) * (t2 * t2);
      s.dw[a][0] = (u - T(1.5)) / dx;
      s.dw[a][1] = (T(-2) * (u - T(1))) / dx;
      s.dw[a][2] = ((u - T(2)) + T(1.5)) / dx;
    } else {
      // u in [1, 2): t = u, u - 1 (in [0, 1)), u - 2 (in [-1, 0)), u - 3
      b = floor_(xs) - T(1);
      const T u = xs - b;
      const T a1 = u - T(1), a2 = -(u - T(2)), a3 = -(u - T(3));
      s.w[a][0] = cubic_outer(u);
      s.w[a][1] = cubic_inner(a1);
      s.w[a][2] = cubic_inner(a2);
      s.w[a][3] = cubic_outer(a3);
      s.dw[a][0] = cubic_outer_grad(u) / dx;
      s.dw[a][1] = (T(1.5) * a1 * a1 - T(2) * a1) / dx;
      s.dw[a][2] = (T(-1.5) * a2 * a2 + T(2) * a2) / dx;
      s.dw[a][3] = -cubic_outer_grad(a3) / dx;
    }
    const int base = (int)b;
#pragma unroll
    for (int o = 0; o < W; ++o) s.c[a][o] = min_(max_(base + o, 0), g.res[a] - 1);
  }
}

// True if no node coordinate of the stencil was clamped.
template <typename T, int D, int W>
__device__ __forceinline__ bool unclamped(const Stencil<T, D, W>& s) {
  bool ok = true;
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int o = 1; o < W; ++o) ok = ok && s.c[a][o] == s.c[a][0] + o;
  return ok;
}

// The node box of the block's `inner` particles. Every thread of the block
// calls this: it synchronises the block twice. A block with no inner
// particle gets an empty box that does not fit.
template <typename T, int D, int W>
__device__ __forceinline__ Window<D> block_window(const Stencil<T, D, W>& s, bool inner,
                                                  int window_nodes, int* s_box) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int a = 0; a < D; ++a) {
      s_box[a] = INT_MAX;
      s_box[D + a] = INT_MIN;
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < D; ++a) {
    const int lo = __reduce_min_sync(0xffffffffu, inner ? s.c[a][0] : INT_MAX);
    const int hi = __reduce_max_sync(0xffffffffu, inner ? s.c[a][W - 1] : INT_MIN);
    if (threadIdx.x % kWarp == 0) {
      atomicMin(&s_box[a], lo);
      atomicMax(&s_box[D + a], hi);
    }
  }
  __syncthreads();
  Window<D> win;
  long long nodes = 1;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    win.lo[a] = s_box[a];
    win.ext[a] = s_box[D + a] >= s_box[a] ? s_box[D + a] - s_box[a] + 1 : 0;
    nodes *= win.ext[a];
  }
  win.nodes = (int)nodes;
  win.fits = nodes > 0 && nodes <= window_nodes;
  return win;
}

// Flat node offsets per axis and stencil offset, from the box's first node
// (in_window) or from grid node 0; a stencil node's index is their sum. On
// the tile grid the direct path's index is tile id * tile^D + local id, which
// NodeMap turns into the compact address.
template <typename T, int D, int W, bool Tiled>
__device__ __forceinline__ void node_offsets(const Stencil<T, D, W>& s, const Window<D>& win,
                                             const Grid<D>& g, bool in_window, int off[D][W]) {
  if (Tiled && !in_window) {
    int local = 1;
#pragma unroll
    for (int a = D - 1; a >= 0; --a) {
#pragma unroll
      for (int o = 0; o < W; ++o) {
        const int c = s.c[a][o];
        off[a][o] = (c / g.tile) * g.tile_stride[a] * g.tile_nodes + (c % g.tile) * local;
      }
      local *= g.tile;
    }
    return;
  }
  int stride = 1;
#pragma unroll
  for (int a = D - 1; a >= 0; --a) {
#pragma unroll
    for (int o = 0; o < W; ++o) off[a][o] = (s.c[a][o] - (in_window ? win.lo[a] : 0)) * stride;
    stride *= in_window ? win.ext[a] : g.res[a];
  }
}

// fn(node index, weight gradient g[D]) for each of the W^D stencil nodes. In
// 3D the outer loop is not unrolled: unrolled, the compiler kept the whole
// stencil's values in flight, the registers cut the blocks an SM holds, and
// occupancy, not instructions, set the kernels' time.
template <typename T, int D, int W, typename Fn>
__device__ __forceinline__ void for_each_node(const Stencil<T, D, W>& s, const int off[D][W],
                                              Fn&& fn) {
  if constexpr (D == 2) {
#pragma unroll
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const T g[2] = {s.dw[0][i] * s.w[1][j], s.w[0][i] * s.dw[1][j]};
        fn(off[0][i] + off[1][j], g);
      }
  } else {
#pragma unroll 1
    for (int i = 0; i < W; ++i)
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const T gx = s.dw[0][i] * s.w[1][j], gy = s.w[0][i] * s.dw[1][j];
        const T w01 = s.w[0][i] * s.w[1][j];
#pragma unroll
        for (int k = 0; k < W; ++k) {
          const T g[3] = {gx * s.w[2][k], gy * s.w[2][k], w01 * s.dw[2][k]};
          fn(off[0][i] + off[1][j] + off[2][k], g);
        }
      }
  }
}

// grad[a][b] = sum_k src[node_k][a] g_k[b] (an inactive node reads 0)
template <typename T, int D, int W, typename Map>
__device__ __forceinline__ void gather_grad(const T* src, const Map& map,
                                            const Stencil<T, D, W>& s, const int off[D][W],
                                            T grad[D][D]) {
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = 0; b < D; ++b) grad[a][b] = T(0);
  for_each_node(s, off, [&](int index, const T* g) {
    const int node = map(index);
    if constexpr (Map::kMayMiss) {
      if (node < 0) return;
    }
#pragma unroll
    for (int a = 0; a < D; ++a) {
      const T va = src[node * D + a];
#pragma unroll
      for (int b = 0; b < D; ++b) grad[a][b] += va * g[b];
    }
  });
}

// dst[node_k][a] += sum_b M[a][b] g_k[b] by global atomicAdd (the direct
// path; an inactive node is skipped).
template <typename T, int D, int W, typename Map>
__device__ __forceinline__ void scatter(T* dst, const Map& map, const Stencil<T, D, W>& s,
                                        const int off[D][W], const T M[D][D]) {
  for_each_node(s, off, [&](int index, const T* g) {
    const int node = map(index);
    if constexpr (Map::kMayMiss) {
      if (node < 0) return;
    }
#pragma unroll
    for (int a = 0; a < D; ++a) {
      T acc = T(0);
#pragma unroll
      for (int b = 0; b < D; ++b) acc += M[a][b] * g[b];
      atomicAdd(&dst[node * D + a], acc);
    }
  });
}

// fn(window entry, grid entry) for every value of the box, the grid entry -1
// where the node's tile is inactive. Dense grid: one warp per row of the box
// along the last axis, the lanes over the row's ext[D-1] * D contiguous
// values. Tile grid: one thread per run of a row inside one tile (at most
// `tile` nodes, contiguous in memory), its slot looked up once.
template <int D, bool Tiled, typename Fn>
__device__ __forceinline__ void for_each_window_entry(const Window<D>& win, const Grid<D>& g,
                                                      Fn&& fn) {
  if constexpr (Tiled) {
    const int ext = win.ext[D - 1], lo = win.lo[D - 1];
    const int t0 = lo / g.tile, runs = (lo + ext - 1) / g.tile - t0 + 1;
    const int units = win.nodes / ext * runs;
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      const int row = u / runs, t = t0 + u % runs;
      int tid = t * g.tile_stride[D - 1], local = 0, lstride = g.tile, r = row;
#pragma unroll
      for (int a = D - 2; a >= 0; --a) {
        const int c = win.lo[a] + r % win.ext[a];
        r /= win.ext[a];
        tid += (c / g.tile) * g.tile_stride[a];
        local += (c % g.tile) * lstride;
        lstride *= g.tile;
      }
      const int slot = g.lookup[tid];
      const int c_lo = max_(lo, t * g.tile), c_hi = min_(lo + ext, (t + 1) * g.tile);
      for (int c = c_lo; c < c_hi; ++c) {
        const int i = row * ext + (c - lo);
        const long long gi =
            slot < 0 ? -1 : ((long long)slot * g.tile_nodes + local + c % g.tile) * D;
#pragma unroll
        for (int a = 0; a < D; ++a) fn(i * D + a, gi < 0 ? -1 : gi + a);
      }
    }
    return;
  }
  const int run = win.ext[D - 1] * D;
  const int rows = win.nodes / win.ext[D - 1];
  const int lane = threadIdx.x % kWarp;
  for (int row = threadIdx.x / kWarp; row < rows; row += blockDim.x / kWarp) {
    long long node = win.lo[D - 1], stride = g.res[D - 1];
    int r = row;
#pragma unroll
    for (int a = D - 2; a >= 0; --a) {
      node += (long long)(win.lo[a] + r % win.ext[a]) * stride;
      r /= win.ext[a];
      stride *= g.res[a];
    }
    for (int e = lane; e < run; e += kWarp) fn(row * run + e, node * D + e);
  }
}

// The box of src into sh.win, and the node counts zeroed.
template <typename T, int D, bool Tiled>
__device__ __forceinline__ void load_window(const T* __restrict__ src, const Shared<T, D>& sh,
                                            const Window<D>& w, const Grid<D>& g) {
  for_each_window_entry<D, Tiled>(w, g, [&](int i, long long gi) {
    sh.win[i] = (Tiled && gi < 0) ? T(0) : src[gi];
  });
  for (int i = threadIdx.x; i <= w.nodes; i += blockDim.x) sh.start[i] = 0;
}

// Step 1: the particle counted at each of its nodes.
template <typename T, int D, int W>
__device__ __forceinline__ void count_nodes(const Shared<T, D>& sh, const Stencil<T, D, W>& s,
                                            const int off[D][W]) {
  for_each_node(s, off, [&](int node, const T*) { atomicAdd(&sh.start[node], 1); });
}

// Inclusive prefix sum over the warp's lanes.
__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += t;
  }
  return v;
}

// Step 2: the exclusive scan of the node counts sh.start[0..n) in place,
// with sh.start[n] = the total, copied to sh.cursor. Each thread scans a
// contiguous chunk; the chunk sums are scanned within each warp by shuffles,
// and every warp scans the warp totals the same way (blockDim.x <= 32 warps).
// Every thread of the block calls this.
template <typename T, int D>
__device__ __forceinline__ void scan_counts(const Shared<T, D>& sh, int n) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min_((int)threadIdx.x * per, n), hi = min_(lo + per, n);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int warps = blockDim.x / kWarp;
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += sh.start[i];
  const int incl = warp_inclusive_scan(sum);
  if (lane == kWarp - 1) sh.scan[warp] = incl;
  __syncthreads();
  const int totals = warp_inclusive_scan(lane < warps ? sh.scan[lane] : 0);
  const int before = __shfl_sync(0xffffffffu, totals, warp == 0 ? 0 : warp - 1);
  int run = (warp == 0 ? 0 : before) + incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int c = sh.start[i];
    sh.start[i] = sh.cursor[i] = run;
    run += c;
  }
  if (threadIdx.x == blockDim.x - 1) sh.start[n] = sh.cursor[n] = run;
  __syncthreads();
}

// Step 3: the contributions sum_b M[a][b] g_k[b] into slots taken from the
// nodes' cursors.
template <typename T, int D, int W>
__device__ __forceinline__ void place(const Shared<T, D>& sh, const Stencil<T, D, W>& s,
                                      const int off[D][W], const T M[D][D]) {
  for_each_node(s, off, [&](int node, const T* g) {
    T* slot = sh.slots + (long long)atomicAdd(&sh.cursor[node], 1) * D;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      T acc = T(0);
#pragma unroll
      for (int b = 0; b < D; ++b) acc += M[a][b] * g[b];
      slot[a] = acc;
    }
  });
}

// Step 4: each node's slots summed per component, each non-zero sum added to
// dst; returns this thread's count of atomics.
template <typename T, int D, bool Tiled>
__device__ __forceinline__ unsigned flush_slots(const Shared<T, D>& sh, T* dst,
                                                const Window<D>& w, const Grid<D>& g) {
  unsigned count = 0;
  for_each_window_entry<D, Tiled>(w, g, [&](int i, long long gi) {
    const int node = i / D, a = i - node * D;
    T v = T(0);
    for (int r = sh.start[node], end = sh.start[node + 1]; r < end; ++r) v += sh.slots[r * D + a];
    if (v != T(0) && !(Tiled && gi < 0)) {
      atomicAdd(&dst[gi], v);
      ++count;
    }
  });
  return count;
}

// Adds the block's counters to stats. Every thread calls this; `atomics` is
// the thread's own count of global atomicAdds.
template <int D>
__device__ __forceinline__ void record_window(unsigned long long* stats, const Window<D>& win,
                                              unsigned atomics) {
  const unsigned warp_atomics = __reduce_add_sync(0xffffffffu, atomics);
  if (threadIdx.x % kWarp == 0) atomicAdd(&stats[kStatAtomics], (unsigned long long)warp_atomics);
  if (threadIdx.x == 0) {
    const unsigned long long nodes = (unsigned long long)win.nodes;
    atomicAdd(&stats[kStatBlocks], 1ull);
    if (!win.fits) atomicAdd(&stats[kStatOverflow], 1ull);
    atomicAdd(&stats[kStatNodes], nodes);
    atomicMax(&stats[kStatMaxNodes], nodes);
    const int bucket = win.nodes > 0 ? 31 - __clz(win.nodes) : 0;
    atomicAdd(&stats[kStatHist + min_(bucket, kStatCount - kStatHist - 1)], 1ull);
  }
}

// The particle kernels' common frame. With the per-particle chain
//   chain(const T* src, const Map& map, const Stencil<T, D, W>& s,
//         const int off[D][W], T M[D][D])
// (a generic lambda, Map being Local, or NodeMap on the tile grid's direct
// path: gather from src at the mapped offsets, compute, leave the scaled
// stress matrix in M; run only for particles p < n) it does the stencil, the box, the window
// load, the gather-and-chain, the sorted scatter through the window or the
// direct one into dst, and the counters.
template <typename T, int D, int W, bool Tiled, typename Chain>
__device__ __forceinline__ void window_frame(const T* __restrict__ src, const T* __restrict__ x,
                                             T dx, const Grid<D>& grid, T* __restrict__ dst,
                                             long long n, int window_nodes,
                                             unsigned long long* __restrict__ stats,
                                             unsigned char* smem, int* s_box, Chain&& chain) {
  constexpr int S = StencilSize<D, W>::value;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = p < n;
  Stencil<T, D, W> s;
  if (valid) stencil_of(x, n, p, dx, grid, s);
  const bool inner = valid && unclamped(s);
  const Window<D> win = block_window(s, inner, window_nodes, s_box);
  const Shared<T, D> sh = carve<T, D, W>(smem, window_nodes);
  if (win.fits) load_window<T, D, Tiled>(src, sh, win, grid);
  __syncthreads();

  const bool windowed = win.fits && inner;
  unsigned atomics = 0;
  int off[D][W];
  T M[D][D];
  if (valid) {
    node_offsets<T, D, W, Tiled>(s, win, grid, windowed, off);
    if (windowed) {
      chain(sh.win, Local{}, s, off, M);
      count_nodes(sh, s, off);
    } else if constexpr (Tiled) {
      const NodeMap map{grid.lookup, grid.tile_nodes};
      chain(src, map, s, off, M);
      scatter(dst, map, s, off, M);
      atomics = S * D;
    } else {
      chain(src, Local{}, s, off, M);
      scatter(dst, Local{}, s, off, M);
      atomics = S * D;
    }
  }
  __syncthreads();
  if (win.fits) {
    scan_counts(sh, win.nodes);
    if (windowed) place(sh, s, off, M);
    __syncthreads();
    atomics += flush_slots<T, D, Tiled>(sh, dst, win, grid);
  }
  if (stats != nullptr) record_window(stats, win, atomics);
}

}  // namespace hot

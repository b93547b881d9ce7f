// Hand-written Hopper (sm_90a) kernels of the mixed-stretch implicit step,
// unstructured (K1-K4, K7) and on structured box grids (K5, K6). One
// translation unit with a plain C interface, built by
// mixedfem_tpu_torch/cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and loaded with ctypes. Every entry point launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError() of its launch.
// Each kernel is a template over float and double. K1 and K3 are templates
// over the element's shape too, with two instances each: 3D linear tets
// (k = 4 corners, d = 3, N = 6 stretch values; entry points without a shape
// suffix) and 2D linear triangles (k = 3, d = 2, N = 3; entry points
// _k3d2 and _n3). The tet instance is the same code as before the shape
// became a parameter, so its sums run in the same order. K1 has two more
// instances, shells (3D triangles: k = 3, d = 3, N = 6; _k3d3) and rods
// (3D segments: k = 2, d = 3, N = 6; _k2d3), and K7 those two shapes.
//
// K1 element_apply  replaces the gather/apply half of
//     mixedfem_tpu/ops/brick.py:_matvec_kernel (via _matvec_call,
//     brick_matvec). Per element e (one thread):
//       pe   = (free_mask * p)[T[e]]                 (4 corners x 3)
//       q    = Gw_e pe                                (6)
//       y_e  = Gw_e^T q + (M_e (x) I3) pe             (4 x 3, written out)
//     Bound: bytes. Gw (72), mass (16), T (4 ints) and y_e (12) per element,
//     ~42 MB at 100k tets f32, ~12.5 us at 3.35 TB/s; 384 flop/element is
//     negligible. Triangles (the instance <3, 2, 3>): Gw (18), mass (9), T
//     (3 ints), y_e (6), ~14.4 MB at 100k triangles f32, ~4.3 us. Shells
//     (<3, 3, 6>): Gw (54), mass (9), T (3 ints), y_e (9), ~30 MB at 100k
//     triangles f32, ~9 us. Rods (<2, 3, 6>): Gw (36), mass (4), T (2
//     ints), y_e (6), ~20 MB at 100k segments f32, ~6 us. Design:
//     the per-element rows are streamed once, p and the mask are gathered
//     (they fit in L2), the sums stay in registers, and the per-corner rows
//     go to K2 for a deterministic vertex sum (no atomics).
//
// K2 segment_sum  replaces mixedfem_tpu/ops/brick.py:_scatter_kernel (via
//     _scatter_call, brick_scatter) and, with K1, the scatter half of
//     _matvec_kernel; it also sums the coarse space's restriction (m=6) and
//     Galerkin blocks (m=36), XLA's segment_sum on the TPU.
//     out[v, c] = sum over the slots j of segment v, in the plan's fixed
//     order, of rows[slots[j], c].
//     Bound: bytes. rows, slots, row_ptr and out, each once: 6.8 MB (m=3),
//     17 MB (m=9) and 238 MB (m=36, 1.6M rows) at 100k tets f32, 2, 5 and
//     71 us at 3.35 TB/s.
//     The first design (a thread per (segment, column) walking its rows, a
//     slot id then its row per step) took 610 us at m=36: 4,193-row tail.
//     Design: the host plan (ops/assembly.py) splits a segment longer than
//     L rows into consecutive pieces of at most L slots; a plan with pieces
//     takes a second launch that sums each segment's partials in piece
//     order. Each launch takes one of two schedules. Tile (rows wider than
//     16 values, or pieces of 32 rows or more on average): one warp per
//     piece loads 32 slot ids at once and gathers those rows into a tile in
//     shared memory with cp.async (16, 8 or 4 bytes a copy), two tiles in
//     turn so the next gather overlaps this sum; lane c adds column c (and
//     c+32) in row order. Lane (narrow rows in short pieces, where staging
//     cost more than it saved on the card): a thread per (piece, column)
//     fetches 32 slot ids, then their values, all in flight, and adds them
//     in order. No atomics. TMA and wgmma do not fit: TMA has no row
//     gather, and a segmented sum does one add per value it loads.
//
// K3 contract_G_Gw  replaces mixedfem_tpu/ops/smallops.py:_tr_kernel (via
//     _pallas_interleave, interleave_cols), the lane transpose that finishes
//     contract_D_dphi and contract_sym_G on the TPU. Per element e:
//       G[i,k,r]  = sum_c D[i,r,c] dphi[k,c]              (6 x 4 x 3)
//       Gw[i,k,r] = sqrt(vol) sum_j Hs[i,j] G[j,k,r]
//     written row-major (E, 6, 4, 3) directly, so no transpose is needed.
//     Bound: bytes. D (54), dphi (12), Hs (36), vol (1) read and G, Gw
//     (144) written per element, ~99 MB at 100k tets f32, ~29.5 us at
//     3.35 TB/s; ~1.3 kflop/element is negligible. Triangles (N = 3, k = 3,
//     d = 2): D (12), dphi (6), Hs (9), vol (1), G and Gw (36), ~25.6 MB at
//     100k triangles f32, ~7.6 us; a tile is 3 TE threads, and a tile's
//     spans stay 16-byte aligned (TE is a multiple of 4), so the same copy
//     units and element-copy tails serve both shapes. The first design (one
//     thread per element, 72 sums in registers, 144 stores at a 288-byte
//     stride that used 4 of each 32-byte sector) took 270.95 us on an
//     NVIDIA H100 80GB HBM3 at 700 W. Design: the TPU kernel's staging,
//     on the card. A block takes TE consecutive elements (kK3Tile), so
//     each input and output of the tile is one contiguous span; the block
//     copies the input spans into shared memory with cp.async (16-byte
//     copies where the array's address allows, else 8 or 4, a span's tail
//     in element copies), one thread per (element, corner k) computes
//     G[:,k,:] and from it Gw[:,k,:] (18 sums each, in the first design's
//     order, so its float32 results are the same bits) into G and Gw tiles
//     in shared memory, and the block stores each tile as one contiguous
//     span with 16-byte stores. 40 registers a thread in f32, 64 in f64, no
//     spills. Measured at 100k tets on an NVIDIA H100 80GB HBM3 at 700 W:
//     37.5 us in f32 (79% of its bound; TE 16 / 32 / 64: 37.6 / 37.4 /
//     38.5 us) and 71.7 us in f64 (bound 59.0 us), from 270.95 us.
//
// K7 contract_Gw  replaces mixedfem_tpu/ops/smallops.py:_tr_kernel where
//     contract_sym_G takes a G that comes from a Jacobian, not from D :
//     dphi: shells (G (E, 6, 3, 3), 54 columns, from the re-linearized
//     membrane Jacobian) and rods (G (E, 6, 2, 3), 36 columns, from the
//     frame-augmented Jacobian), mixedfem_tpu/variables/mixed_stretch.py:
//     90-104 and :65. Per element e:
//       Gw[i,k,r] = sqrt(vol) sum_j Hs[i,j] G[j,k,r]
//     K3's second half on a given G, with K3's staging: a block takes TE =
//     32 consecutive elements, copies the Hs, vol and G spans into shared
//     memory with cp.async, one thread per (element, corner k) forms
//     Gw[:,k,:] (N x d sums over j ascending, then the sqrt(vol) product, as
//     K3 does), and the block stores the Gw tile as one contiguous span. Bound: bytes. Hs (36), G and Gw
//     (54 each) and vol (1) per shell, ~58 MB at 100k shells f32, ~17 us at
//     3.35 TB/s; Hs (36), G and Gw (36 each) and vol per rod segment, ~45
//     MB at 100k segments, ~13 us; ~1.2 kflop/element is negligible.
//
// K4 banded_sum  replaces mixedfem_tpu/ops/pallas_scatter.py:_make_kernel
//     (via _scatter_call, scatter_add_sorted): out[v] = sum of the rows
//     (Rp, m), in banded element order, of vertex v; it carries the matvec
//     and assemblies of every loaded scene. The TPU kept a window of W
//     vertices of the output in VMEM across a sequential grid; on this card
//     the same function is a per-vertex gather over a CSR of the banded rows
//     (ops/banded_scatter.py; ascending, without the zero padding rows) with
//     K2's code in one pass, so W does not enter. Bound: bytes. rows, an
//     int32 vertex id per row and out: 6.7 / 16.9 MB (m=3 / 9) at 100k tets
//     f32, 2.0 / 5.0 us. The first design (per-chunk partials, then a sum per
//     vertex) took 21-30 us: 196 latency-bound blocks, partials through L2.
//
// K5 stencil_apply  is the CG matvec of the structured-grid path, the
//     function of mixedfem_tpu/ops/stencil.py:matvec_lat (XLA on the TPU,
//     27 shifted block products) with the CG's free mask fused:
//       y[a,v] = fm[a,v] sum_{o used} sum_b W[o,a,b,v] x[b, v + shift_o]
//     on the ghost-padded vertex lattice (NI+2, NJ+2, NK+2), y = 0 at the
//     ghosts. Bound: bytes. The 19 planes of W that the 5-tet split uses,
//     and x, fm and y once: 19.9 MB at 100k tets f32 (27,692 lattice
//     vertices), 5.9 us at 3.35 TB/s; 2 flop per W value is negligible.
//     Design: a thread per (row a of y, lattice vertex), 128 threads a
//     block. The used planes come by value as flat shifts, and a mask of
//     exactly 19 planes takes a path whose plane loop is unrolled at
//     compile time (all 19 planes in float32, 10 at a time in float64), so
//     a thread's loads of W wait on no branch; any other mask takes the
//     same kernel's runtime loop. W is feature-major with the vertex minor,
//     so each load of W is coalesced across a warp. x[v + shift] comes
//     from L1/L2 (the three rows of x are 0.33 MB), and a ghost reads x at
//     vertex (1, 1, 1), whose shifts stay in the array, and writes 0.
//     Planes are added in ascending order, each as w0 x0 + w1 x1 + w2 x2, the
//     free mask last, as in the previous design, so y keeps its bits.
//     Measured at 100k tets on an NVIDIA H100 80GB HBM3 at 700.00 W: 12.19
//     us in f32 with W read from device memory (2.0x its bound; 17.56 in the
//     previous design, whose per-plane branch held back its loads), 6.51 us
//     with W in L2 (9.28); 22.25 / 16.64 us in f64 (bound 11.90; 18.65 /
//     12.37), where ptxas gives the kernel 32 registers and issues few
//     planes' loads together (a form of this body with one-element arrays
//     got 80 registers and 17.2 us; a full unroll was slower). Trial builds
//     on that card with 2 or 4 consecutive vertices a thread (vector loads
//     of W) took 16.0 and 25.7 us cold, the x reads no longer coalescing;
//     64, 128 and 256 threads a block were within 0.5% of one another; x
//     staged through shared memory with its halo took 18.0 us or more.
//
// K6 stencil_assemble  builds W once per Newton iteration, the function of
//     mixedfem_tpu/ops/stencil.py:_assemble_terms (XLA on the TPU, ~160
//     masked pad-and-sum windows): for each term (slot t, corners a and b,
//     cell parity p, corner offset ca of a, plane o) and each cell c of
//     parity p, the block sum_n Gw[e,n,a,:] (x) Gw[e,n,b,:] + mass[e,a,b] I
//     of element e = c * nslots + t is added to W[o,:,:,c + ca]. Bound:
//     bytes. Gw (28.8 MB) and mass (6.4 MB) read once and the 19 planes of
//     W that the terms touch written once (18.9 MB; the other 8 are zeros
//     that need not be stored): 54.1 MB at 100k tets f32, 16.2 us at 3.35
//     TB/s. Design: gather, no atomics. The 8 planes no term touches are
//     written as zeros by a launch of vector stores. A block takes a tile
//     of TI x TJ x TK lattice vertices and copies the cells around it, a
//     line of cells along k being one span of Gw, into shared memory with
//     cp.async. A vertex of even parity takes 128 terms and one of odd
//     parity 32, the centre plane 32 and 8 of them; the host schedule
//     (ops/stencil.py:k6_schedule) deals each parity's planes into jobs of
//     whole planes, 4 + 1 jobs of 32 terms for a pair of vertices along k,
//     and a thread per (pair, job, row of the block) adds each of its
//     planes' terms in the plan's order, so that every sum keeps the previous
//     design's order and W its bits. Tile 2 x 2 x 6 and 192 threads in
//     float32, 1 x 2 x 8 and 128 in float64 (the best of a sweep of 6 and 4
//     tiles in trial builds on the card), two blocks an SM in float32.
//     Measured at 100k tets on an NVIDIA H100 80GB HBM3 at 700.00 W: 91.81
//     us in f32 (5.7x its bound; 246.09 in the previous design, a warp per
//     plane whose lanes read elements 1,440 bytes apart and whose
//     centre-plane warp added 20 blocks a vertex against about 3), 203.81
//     us in f64 (bound 32.32; 468.31). What holds it there:
//     shared-memory reads (25 a thread and term, with bank conflicts between
//     the cells of neighbouring pairs), the tile's halo (63 cells staged for
//     24 vertices, each cell in reach of 8), and the plan's order, which
//     keeps each plane's sum on one thread.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
// K2 / K4: warps per block, rows per tile, widest row (two columns a lane)
constexpr int kSegWarps = 4;
constexpr int kTile = 32;
constexpr int kMaxWidth = 64;

// K1 for elements of K corners in DIM dimensions with N stretch values:
// one thread per element
template <typename T, int K, int DIM, int N>
__global__ void element_apply_kernel(const int* __restrict__ tets,
                                     const T* __restrict__ gw,
                                     const T* __restrict__ mass,
                                     const T* __restrict__ free_mask,
                                     const T* __restrict__ p,
                                     T* __restrict__ out, int n_elem) {
  constexpr int KD = K * DIM;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_elem) return;
  T pe[KD];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int v = tets[K * e + c];
    const T f = free_mask[v];
#pragma unroll
    for (int r = 0; r < DIM; ++r) pe[DIM * c + r] = f * p[DIM * v + r];
  }
  const T* g = gw + N * KD * static_cast<size_t>(e);
  T q[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc = T(0);
#pragma unroll
    for (int a = 0; a < KD; ++a) acc += g[KD * i + a] * pe[a];
    q[i] = acc;
  }
  const T* m = mass + K * K * static_cast<size_t>(e);
  T* y = out + KD * static_cast<size_t>(e);
#pragma unroll
  for (int c = 0; c < K; ++c) {
#pragma unroll
    for (int r = 0; r < DIM; ++r) {
      const int a = DIM * c + r;
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < N; ++i) acc += g[KD * i + a] * q[i];
#pragma unroll
      for (int l = 0; l < K; ++l) acc += m[K * c + l] * pe[DIM * l + r];
      y[a] = acc;
    }
  }
}

// cp.async of B bytes to shared memory; commit a group; wait for all but one
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(B) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

#define SEG_PARAMS const int *__restrict__ ptr, const int *__restrict__ slots, \
    const T *__restrict__ rows, T *__restrict__ out, int n_seg, int m

// K2's and K4's two schedules sum, for segment g, rows[slots[j]] (m values
// of T) for j in [ptr[g], ptr[g+1]) in order into out[g]; slots == nullptr
// means slots[j] = j (partials). Tile: one warp per segment, slot ids a tile
// ahead, copies in units of B bytes, NC = ceil(m / 32) columns a lane.
template <typename T, int B, int NC>
__device__ __forceinline__ void tile_segment_sum(SEG_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, g = blockIdx.x * kSegWarps + (threadIdx.x >> 5);
  if (g >= n_seg) return;  // the whole warp leaves together
  const int row_bytes = m * static_cast<int>(sizeof(T)), per_row = row_bytes / B;
  char* tiles = reinterpret_cast<char*>(smem_raw) + (threadIdx.x >> 5) * 2 * kTile * row_bytes;
  const char* src = reinterpret_cast<const char*>(rows);
  const int beg = ptr[g], n = ptr[g + 1] - beg;
  auto slot_of = [&](int j) { return j < n ? (slots != nullptr ? slots[beg + j] : beg + j) : 0; };
  T acc[NC] = {};
  // round t gathers tile t into buffer t % 2 and sums tile t - 1
  int next = slot_of(lane);
  for (int t0 = 0, cur = 0; t0 < n + kTile; t0 += kTile, cur ^= 1) {
    // every lane runs the same copy rounds, so the shuffle sees the warp
    const int units = min(max(n - t0, 0), kTile) * per_row;
    for (int q0 = 0; q0 < units; q0 += 32) {
      const int q = q0 + lane, r = q / per_row;
      const int sid = __shfl_sync(0xffffffffu, next, r & 31);
      if (q < units) {
        const int u = (q - r * per_row) * B;
        cp_async<B>(tiles + (cur * kTile + r) * row_bytes + u,
                    src + static_cast<size_t>(sid) * row_bytes + u);
      }
    }
    cp_async_commit();                  // (empty after the last tile)
    next = slot_of(t0 + kTile + lane);  // ids of the next tile
    if (t0 == 0) continue;
    cp_async_wait_one();                // tile t - 1 has landed
    __syncwarp();
    const T* tile = reinterpret_cast<const T*>(tiles + (cur ^ 1) * kTile * row_bytes);
    const int nr = min(n - (t0 - kTile), kTile);
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = lane + 32 * k;
      if (c < m) {
#pragma unroll 4
        for (int r = 0; r < nr; ++r) acc[k] += tile[r * m + c];
      }
    }
    __syncwarp();  // before the next round overwrites this buffer
  }
#pragma unroll
  for (int k = 0; k < NC; ++k)
    if (lane + 32 * k < m) out[static_cast<size_t>(g) * m + lane + 32 * k] = acc[k];
}

// Lane: one thread per (segment, column); up to 32 slot ids, then their
// values, in flight at once. Takes slots != nullptr only.
template <typename T>
__device__ __forceinline__ void lane_segment_sum(SEG_PARAMS) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(n_seg) * m) return;
  const int g = static_cast<int>(idx / m), c = static_cast<int>(idx - static_cast<long long>(g) * m);
  const int end = ptr[g + 1];
  T acc = T(0);
  for (int j0 = ptr[g]; j0 < end; j0 += kTile) {
    int id[kTile];
    T x[kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i) id[i] = j0 + i < end ? slots[j0 + i] : -1;
#pragma unroll
    for (int i = 0; i < kTile; ++i) x[i] = id[i] >= 0 ? rows[static_cast<size_t>(id[i]) * m + c] : T(0);
#pragma unroll
    for (int i = 0; i < kTile; ++i)
      if (j0 + i < end) acc += x[i];
  }
  out[idx] = acc;
}

// K2, and K4 under its own name so that a profile tells the two apart
#define SEG_KERNELS(NAME)                                                    \
  template <typename T, int B, int NC>                                       \
  __global__ void __launch_bounds__(kSegWarps * 32) NAME##_tile(SEG_PARAMS) { \
    tile_segment_sum<T, B, NC>(ptr, slots, rows, out, n_seg, m);             \
  }                                                                          \
  template <typename T>                                                      \
  __global__ void NAME##_lane(SEG_PARAMS) {                                  \
    lane_segment_sum<T>(ptr, slots, rows, out, n_seg, m);                    \
  }
SEG_KERNELS(segment_sum_kernel)
SEG_KERNELS(banded_sum_kernel)

// K3's element shape: K corners in DIM dimensions, N stretch values, and
// the values per element of D, dphi, Hs and of G (and Gw); a tile's spans
// lie in shared memory in the order D, dphi, Hs, vol, G, Gw
template <int K_, int DIM_, int N_>
struct K3Shape {
  static constexpr int K = K_, DIM = DIM_, N = N_;
  static constexpr int D = N * DIM * DIM, Phi = K * DIM, Hs = N * N, G = N * K * DIM;
  static constexpr int Vals = D + Phi + Hs + 1 + 2 * G;
};
using K3Tet = K3Shape<4, 3, 6>;  // 54, 12, 36 and 72 values
using K3Tri = K3Shape<3, 2, 3>;  // 12, 6, 9 and 18 values
constexpr int kK3Tile = 32;  // elements per block, by chip_smoke.py's sweep

template <int B>
using Vec = std::conditional_t<B == 16, uint4, std::conditional_t<B == 8, uint2, unsigned>>;

// block-wide copy of bytes [lo, hi) in B-byte units: into shared memory
// with cp.async (kIn), or out of it with vector stores
template <int B, bool kIn>
__device__ __forceinline__ void copy_units(char* dst, const char* src, int lo, int hi) {
  const int step = B * static_cast<int>(blockDim.x);
  for (int q = lo + B * static_cast<int>(threadIdx.x); q < hi; q += step) {
    if constexpr (kIn)
      cp_async<B>(dst + q, src + q);
    else
      *reinterpret_cast<Vec<B>*>(dst + q) = *reinterpret_cast<const Vec<B>*>(src + q);
  }
}

// block-wide copy of a span of `bytes` (a multiple of sizeof(T)) whose
// global end is aligned to `unit` (16, 8 or 4): unit copies, then the tail
template <typename T, bool kIn>
__device__ __forceinline__ void copy_span(void* dst, const void* src, int bytes, int unit) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  const int body = bytes - bytes % unit;
  if (unit == 16)
    copy_units<16, kIn>(d, s, 0, body);
  else if (unit == 8)
    copy_units<8, kIn>(d, s, 0, body);
  else
    copy_units<4, kIn>(d, s, 0, body);
  copy_units<static_cast<int>(sizeof(T)), kIn>(d, s, body, bytes);
}

// copy unit of each global array, from its address (a tile's offset into
// every array is a multiple of 16 bytes)
struct K3Units {
  int D, dphi, Hs, vol, G, Gw;
};

inline int copy_unit(const void* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : 4;
}

// one block per tile of TE elements of shape S, a thread per (element,
// corner)
template <typename T, int TE, typename S>
__global__ void __launch_bounds__(S::K * TE) contract_G_Gw_kernel(
    const T* __restrict__ D, const T* __restrict__ dphi,
    const T* __restrict__ Hs, const T* __restrict__ vol, T* __restrict__ G,
    T* __restrict__ Gw, int n_elem, K3Units u) {
  constexpr int K = S::K, DIM = S::DIM, N = S::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sD = reinterpret_cast<T*>(smem_raw);
  T* sPhi = sD + S::D * TE;
  T* sHs = sPhi + S::Phi * TE;
  T* sVol = sHs + S::Hs * TE;
  T* sG = sVol + TE;
  T* sGw = sG + S::G * TE;
  const size_t e0 = static_cast<size_t>(blockIdx.x) * TE;
  const int n = min(TE, n_elem - static_cast<int>(e0));
  const int sz = static_cast<int>(sizeof(T));
  copy_span<T, true>(sD, D + S::D * e0, S::D * n * sz, u.D);
  copy_span<T, true>(sPhi, dphi + S::Phi * e0, S::Phi * n * sz, u.dphi);
  copy_span<T, true>(sHs, Hs + S::Hs * e0, S::Hs * n * sz, u.Hs);
  copy_span<T, true>(sVol, vol + e0, n * sz, u.vol);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int el = threadIdx.x / K, k = threadIdx.x % K;
  if (el < n) {
    const T* d = sD + S::D * el;
    T ph[DIM];
#pragma unroll
    for (int c = 0; c < DIM; ++c) ph[c] = sPhi[S::Phi * el + DIM * k + c];
    T g[N * DIM];
    T* go = sG + S::G * el + DIM * k;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int r = 0; r < DIM; ++r) {
        T acc = T(0);
#pragma unroll
        for (int c = 0; c < DIM; ++c) acc += d[DIM * DIM * i + DIM * r + c] * ph[c];
        g[DIM * i + r] = acc;
        go[K * DIM * i + r] = acc;
      }
    }
    const T sq = sqrt(sVol[el]);
    const T* h = sHs + S::Hs * el;
    T* wo = sGw + S::G * el + DIM * k;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T hi[N];
#pragma unroll
      for (int j = 0; j < N; ++j) hi[j] = h[N * i + j];
#pragma unroll
      for (int r = 0; r < DIM; ++r) {
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < N; ++j) acc += hi[j] * g[DIM * j + r];
        wo[K * DIM * i + r] = sq * acc;
      }
    }
  }
  __syncthreads();
  copy_span<T, false>(G + S::G * e0, sG, S::G * n * sz, u.G);
  copy_span<T, false>(Gw + S::G * e0, sGw, S::G * n * sz, u.Gw);
}

// K7's element shape: K corners in DIM dimensions, N stretch values, and
// the values per element of Hs and of G (and Gw); a tile's spans lie in
// shared memory in the order Hs, vol, G, Gw
template <int K_, int DIM_, int N_>
struct K7Shape {
  static constexpr int K = K_, DIM = DIM_, N = N_;
  static constexpr int Hs = N * N, G = N * K * DIM;
  static constexpr int Vals = Hs + 1 + 2 * G;
};
constexpr int kK7Tile = 32;  // elements per block, K3's tile

// copy unit of each global array of K7
struct K7Units {
  int Hs, G, vol, Gw;
};

// one block per tile of TE elements of shape S, a thread per (element,
// corner)
template <typename T, int TE, typename S>
__global__ void __launch_bounds__(S::K * TE) contract_Gw_kernel(
    const T* __restrict__ Hs, const T* __restrict__ G,
    const T* __restrict__ vol, T* __restrict__ Gw, int n_elem, K7Units u) {
  constexpr int K = S::K, DIM = S::DIM, N = S::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sHs = reinterpret_cast<T*>(smem_raw);
  T* sVol = sHs + S::Hs * TE;
  T* sG = sVol + TE;
  T* sGw = sG + S::G * TE;
  const size_t e0 = static_cast<size_t>(blockIdx.x) * TE;
  const int n = min(TE, n_elem - static_cast<int>(e0));
  const int sz = static_cast<int>(sizeof(T));
  copy_span<T, true>(sHs, Hs + S::Hs * e0, S::Hs * n * sz, u.Hs);
  copy_span<T, true>(sVol, vol + e0, n * sz, u.vol);
  copy_span<T, true>(sG, G + S::G * e0, S::G * n * sz, u.G);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int el = threadIdx.x / K, k = threadIdx.x % K;
  if (el < n) {
    const T* gi = sG + S::G * el + DIM * k;
    T g[N * DIM];
#pragma unroll
    for (int j = 0; j < N; ++j) {
#pragma unroll
      for (int r = 0; r < DIM; ++r) g[DIM * j + r] = gi[K * DIM * j + r];
    }
    const T sq = sqrt(sVol[el]);
    const T* h = sHs + S::Hs * el;
    T* wo = sGw + S::G * el + DIM * k;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T hi[N];
#pragma unroll
      for (int j = 0; j < N; ++j) hi[j] = h[N * i + j];
#pragma unroll
      for (int r = 0; r < DIM; ++r) {
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < N; ++j) acc += hi[j] * g[DIM * j + r];
        wo[K * DIM * i + r] = sq * acc;
      }
    }
  }
  __syncthreads();
  copy_span<T, false>(Gw + S::G * e0, sGw, S::G * n * sz, u.Gw);
}

// K5's planes: the used offsets, ascending, as flat lattice shifts and as
// the first of their 9 rows of W (9 o); passed by value
struct K5Planes {
  int n;
  int shift[27];
  int row[27];
};

// the planes of the 5-tet split (ops/stencil.py), K5's unrolled path
constexpr int kK5Planes = 19;
// K5's threads a block
constexpr int kK5Threads = 128;
// planes whose loads a K5 thread issues together: all 19 in float32, 10 in
// float64, which moves twice the bytes a plane (see K5's note above)
template <typename T>
constexpr int kK5Unroll = sizeof(T) == 4 ? kK5Planes : 10;

// K5: a thread per (row a of y, lattice vertex v of the (NI+2, NJ+2, NK+2)
// lattice); blockIdx.y is a. NP > 0: exactly NP planes, the loop unrolled,
// so a thread's loads of W do not wait on one another; NP == 0: p.n planes.
template <typename T, int NP>
__global__ void stencil_apply_kernel(
    const T* __restrict__ W, const T* __restrict__ x, const T* __restrict__ fm,
    T* __restrict__ y, int NI, int NJ, int NK, K5Planes p) {
  const int NJp = NJ + 2, NKp = NK + 2;
  const int npad = (NI + 2) * NJp * NKp;
  const int v = blockIdx.x * blockDim.x + threadIdx.x, a = blockIdx.y;
  if (v >= npad) return;
  // the x base: the vertex itself inside the lattice; vertex (1, 1, 1) at a
  // ghost, whose every shift stays in the array (its sum is thrown away)
  const int k = v % NKp, j = (v / NKp) % NJp, i = v / (NJp * NKp);
  const bool inner = i > 0 && j > 0 && k > 0 && i <= NI && j <= NJ && k <= NK;
  const int xv = inner ? v : NJp * NKp + NKp + 1;
  T acc = T(0);
  auto plane = [&](int q) {
    const T* w = W + static_cast<size_t>(p.row[q] + 3 * a) * npad + v;
    const int u = xv + p.shift[q];
    acc += w[0] * x[u] + w[npad] * x[npad + u] + w[2 * npad] * x[2 * npad + u];
  };
  if constexpr (NP > 0) {
#pragma unroll(kK5Unroll<T>)
    for (int q = 0; q < NP; ++q) plane(q);
  } else {
#pragma unroll 1
    for (int q = 0; q < p.n; ++q) plane(q);
  }
  y[static_cast<size_t>(a) * npad + v] =
      inner ? (fm == nullptr ? acc : acc * fm[static_cast<size_t>(a) * npad + v]) : T(0);
}

// K6's tile (TI x TJ x TK lattice vertices, TK even) and threads a block
// for each type, the best of a sweep on the card (see K6's note above);
// float64 takes a smaller tile, so that its cells fit in shared memory
struct K6Tile {
  int TI, TJ, TK, threads;
};
template <typename T>
__host__ __device__ constexpr K6Tile k6_tile() {
  return sizeof(T) == 4 ? K6Tile{2, 2, 6, 192} : K6Tile{1, 2, 8, 128};
}
// (K6 is bounded at one block an SM, which lets the compiler keep both
// terms' loads in registers; without that bound it held fewer and ran
// slower in trial runs)
constexpr int kK6MaxThreads = 256;
// K6: terms whose loads a thread has in flight at once
constexpr int kK6Terms = 2;

// N values of T at one aligned address: one vector store
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// K6's zero planes: the planes no term touches (plane_ptr[o] ==
// plane_ptr[o + 1]) written as zeros, N values a store where the plane's
// start allows it; blockIdx.y is the plane
template <typename T, int N>
__global__ void stencil_zero_planes_kernel(const int* __restrict__ plane_ptr, T* __restrict__ W,
                                           int npad) {
  const int o = blockIdx.y;
  if (plane_ptr[o] != plane_ptr[o + 1]) return;
  const long long n = 9LL * npad;
  T* w = W + o * n;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const Pack<T, N> zero{};
  for (long long q = t0; q < n / N; q += step) reinterpret_cast<Pack<T, N>*>(w)[q] = zero;
  for (long long q = n / N * N + t0; q < n; q += step) w[q] = T(0);
}

// K6: a block per tile of TI x TJ x TK lattice vertices. The block copies
// the (TI+1)(TJ+1)(TK+1) cells around the tile into shared memory (a warp
// per cell, Gw then mass of the cell's slots, cs values a cell, cs odd so
// that neighbouring cells start in other banks) and turns the schedule's
// entries into offsets in that layout; then a thread per (pair of vertices
// along k, job, row r) adds, for each plane of its job, the plane's terms
// in the plan's order into the 3 sums of row r, with the loads of two terms
// in flight at once, and stores them. The schedule
// (ops/stencil.py:k6_schedule): [0] J0, [1] J1 (jobs of the vertex of even
// parity, then of odd), [2] plane records, [3] term entries, [4 .. 4 + J0 +
// J1] job_ptr, then (plane o, first entry, end entry) per record, then the
// entries (term row ids, plan order within a plane; one per term row, so
// nterms of them: shared memory is laid out for that many, and a schedule
// that names another count stops the kernel).
template <typename T>
__global__ void __launch_bounds__(kK6MaxThreads, 1) stencil_assemble_kernel(
    const T* __restrict__ gw, const T* __restrict__ mass, const int* __restrict__ terms,
    const int* __restrict__ sched, T* __restrict__ W, int NI, int NJ, int NK, int nslots,
    int nterms, int sched_len, int cs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr K6Tile tl = k6_tile<T>();
  const int NIp = NI + 2, NJp = NJ + 2, NKp = NK + 2;
  const int NIc = NI - 1, NJc = NJ - 1, NKc = NK - 1;
  const int npad = NIp * NJp * NKp;
  const int ntj = (NJp + tl.TJ - 1) / tl.TJ, ntk = (NKp + tl.TK - 1) / tl.TK;
  const int i0 = blockIdx.x / (ntj * ntk) * tl.TI;
  const int j0 = blockIdx.x / ntk % ntj * tl.TJ;
  const int k0 = blockIdx.x % ntk * tl.TK;
  const int CJ = tl.TJ + 1, CK = tl.TK + 1, ncell = (tl.TI + 1) * CJ * CK;
  const int J0 = sched[0], J = J0 + sched[1], nrec = sched[2], nent = nterms;
  if (sched[3] != nterms) __trap();
  // shared memory: the entries (int4), the schedule, then the cells
  int4* s_ent = reinterpret_cast<int4*>(smem_raw);
  int* s_sched = reinterpret_cast<int*>(s_ent + nent);
  T* cells = reinterpret_cast<T*>(smem_raw + ((16 * nent + 4 * sched_len + 15) & ~15));
  const int gvals = 72 * nslots, mvals = 16 * nslots;
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int c = threadIdx.x >> 5; c < ncell; c += nwarps) {
    const int lk = c % CK, lj = c / CK % CJ, li = c / (CK * CJ);
    const int ci = i0 - 2 + li, cj = j0 - 2 + lj, ck = k0 - 2 + lk;
    if (ci < 0 || cj < 0 || ck < 0 || ci >= NIc || cj >= NJc || ck >= NKc) continue;
    const size_t cell = (static_cast<size_t>(ci) * NJc + cj) * NKc + ck;
    T* dst = cells + c * cs;
    for (int u = lane; u < gvals; u += 32) cp_async<sizeof(T)>(dst + u, gw + cell * gvals + u);
    for (int u = lane; u < mvals; u += 32) cp_async<sizeof(T)>(dst + gvals + u, mass + cell * mvals + u);
  }
  cp_async_commit();
  for (int q = threadIdx.x; q < sched_len; q += blockDim.x) s_sched[q] = sched[q];
  // an entry, from its term row (slot, a, b, parity, ca, 0): the offset of
  // its cell below the vertex's cell v - 1 (ca = 0), the offsets of Gw[t, :,
  // a] and Gw[t, :, b] and of mass[t, a, b] in a cell, and ca as 4 cai + 2
  // caj + cak
  const int* ents = sched + 5 + J + 3 * nrec;
  for (int e = threadIdx.x; e < nent; e += blockDim.x) {
    const int* tm = terms + 8 * ents[e];
    const int t = tm[0], a = tm[1], b = tm[2];
    s_ent[e] = make_int4(((tm[4] * CJ + tm[5]) * CK + tm[6]) * cs, (72 * t + 3 * a) | (72 * t + 3 * b) << 16,
                         gvals + 16 * t + 4 * a + b, 4 * tm[4] + 2 * tm[5] + tm[6]);
  }
  cp_async_wait_all();
  __syncthreads();

  const int* job_ptr = s_sched + 4;
  const int* recs = job_ptr + J + 1;
  const int half = tl.TK / 2, npairs = tl.TI * tl.TJ * half;
  for (int w3 = threadIdx.x; w3 < 3 * npairs * J; w3 += blockDim.x) {
    const int w = w3 / 3, r = w3 - 3 * w;
    const int job = w / npairs, pair = w - job * npairs;
    const int pk = pair % half, pj = pair / half % tl.TJ, pi = pair / (half * tl.TJ);
    const int vi = i0 + pi, vj = j0 + pj, vk0 = k0 + 2 * pk;
    // the pair's vertex of even parity takes jobs [0, J0), the other the rest
    const int vk = vk0 + (((vi + vj + vk0) & 1) != (job >= J0 ? 1 : 0));
    if (vi >= NIp || vj >= NJp || vk >= NKp) continue;
    // bit 4 cai + 2 caj + cak: the cell v - 1 - ca lies in the lattice
    unsigned ok = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int ci = vi - 1 - (q >> 2), cj = vj - 1 - (q >> 1 & 1), ck = vk - 1 - (q & 1);
      ok |= static_cast<unsigned>(ci >= 0 && cj >= 0 && ck >= 0 && ci < NIc && cj < NJc && ck < NKc) << q;
    }
    const T* vcell = cells + (((pi + 1) * CJ + pj + 1) * CK + vk - k0 + 1) * cs;
    for (int rc = job_ptr[job]; rc < job_ptr[job + 1]; ++rc) {
      T acc[3] = {T(0), T(0), T(0)};
      const int end = recs[3 * rc + 2];
      for (int e0 = recs[3 * rc + 1]; e0 < end; e0 += kK6Terms) {
        // the loads of kK6Terms terms first, then their row of the block
        // sum_n Gw[e, n, a] (x) Gw[e, n, b] + mass[e, a, b] I, in the previous
        // design's order; a term is added where its cell exists (an absent
        // cell's slot in shared memory was never filled)
        T ga[kK6Terms][6], gb[kK6Terms][18], m[kK6Terms];
        bool use[kK6Terms];
#pragma unroll
        for (int u = 0; u < kK6Terms; ++u) {
          const int4 d = s_ent[min(e0 + u, end - 1)];
          use[u] = e0 + u < end && ((ok >> d.w) & 1u);
          const T* cell = vcell - d.x;
          const T* pa = cell + (d.y & 0xffff) + r;
          const T* pb = cell + (d.y >> 16);
#pragma unroll
          for (int n = 0; n < 6; ++n) {
            ga[u][n] = pa[12 * n];
#pragma unroll
            for (int s = 0; s < 3; ++s) gb[u][3 * n + s] = pb[12 * n + s];
          }
          m[u] = cell[d.z];
        }
#pragma unroll
        for (int u = 0; u < kK6Terms; ++u) {
          T c[3];
#pragma unroll
          for (int s = 0; s < 3; ++s) c[s] = ga[u][0] * gb[u][s];
#pragma unroll
          for (int n = 1; n < 6; ++n)
#pragma unroll
            for (int s = 0; s < 3; ++s) c[s] += ga[u][n] * gb[u][3 * n + s];
#pragma unroll
          for (int s = 0; s < 3; ++s)
            if (s == r) c[s] += m[u];
          if (use[u])
#pragma unroll
            for (int s = 0; s < 3; ++s) acc[s] += c[s];
        }
      }
      T* wo = W + static_cast<size_t>(9 * recs[3 * rc] + 3 * r) * npad + (static_cast<size_t>(vi) * NJp + vj) * NKp + vk;
#pragma unroll
      for (int s = 0; s < 3; ++s) wo[static_cast<size_t>(s) * npad] = acc[s];
    }
  }
}

inline unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

template <typename T, int B, int NC>
cudaError_t launch_tile(bool banded, SEG_PARAMS, cudaStream_t s) {
  auto kernel = banded ? banded_sum_kernel_tile<T, B, NC> : segment_sum_kernel_tile<T, B, NC>;
  const size_t smem = static_cast<size_t>(kSegWarps) * 2 * kTile * m * sizeof(T);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)  // opt in above the default 48 KB
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<(n_seg + kSegWarps - 1) / kSegWarps, kSegWarps * 32, smem, s>>>(ptr, slots, rows, out, n_seg, m);
  return cudaGetLastError();
}

// one launch over the CSR `ptr` of n_seg segments and n_rows slots: the lane
// schedule for rows of up to 16 values in segments of under 32 rows on
// average, else (and for partials) the tile schedule in the widest copy unit
// that the rows' bytes and their address allow
template <typename T>
cudaError_t launch_cols(bool banded, SEG_PARAMS, long long n_rows, cudaStream_t s) {
  if (n_seg <= 0) return cudaSuccess;
  if (slots != nullptr && m <= 16 && n_rows < static_cast<long long>(kTile) * n_seg) {
    auto kernel = banded ? banded_sum_kernel_lane<T> : segment_sum_kernel_lane<T>;
    kernel<<<blocks_for(static_cast<long long>(n_seg) * m), kThreads, 0, s>>>(ptr, slots, rows, out, n_seg, m);
    return cudaGetLastError();
  }
  const size_t bytes = static_cast<size_t>(m) * sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(rows);
  const int unit = bytes % 16 == 0 && addr % 16 == 0  ? 16
                   : bytes % 8 == 0 && addr % 8 == 0 ? 8 : 4;
#define MF_TILE(B, NC) launch_tile<T, B, NC>(banded, ptr, slots, rows, out, n_seg, m, s)
  if (m > 32) return unit == 16 ? MF_TILE(16, 2) : unit == 8 ? MF_TILE(8, 2) : MF_TILE(4, 2);
  return unit == 16 ? MF_TILE(16, 1) : unit == 8 ? MF_TILE(8, 1) : MF_TILE(4, 1);
#undef MF_TILE
}

// K2 and K4 over n_slots slots: without pieces (piece_ptr == nullptr) one
// launch over row_ptr; with pieces one over piece_ptr into part (n_pieces,
// m), then one over seg_pieces that sums each segment's partials in order.
template <typename T>
int launch_segment_sum(bool banded, const int* row_ptr, const int* slots,
                       const int* piece_ptr, const int* seg_pieces, const T* rows,
                       T* part, T* out, int n_seg, int n_pieces, int n_slots,
                       int m, void* stream) {
  if (m <= 0 || m > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = piece_ptr == nullptr
      ? launch_cols<T>(banded, row_ptr, slots, rows, out, n_seg, m, n_slots, s)
      : launch_cols<T>(banded, piece_ptr, slots, rows, part, n_pieces, m, n_slots, s);
  if (err == cudaSuccess && piece_ptr != nullptr)
    err = launch_cols<T>(banded, seg_pieces, nullptr, part, out, n_seg, m, n_pieces, s);
  return static_cast<int>(err);
}

template <typename T, int TE, typename S>
cudaError_t launch_contract(const T* D, const T* dphi, const T* Hs, const T* vol,
                            T* G, T* Gw, int n_elem, cudaStream_t s) {
  auto kernel = contract_G_Gw_kernel<T, TE, S>;
  const size_t smem = static_cast<size_t>(S::Vals) * TE * sizeof(T);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)  // opt in above the default 48 KB
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const K3Units u{copy_unit(D), copy_unit(dphi), copy_unit(Hs), copy_unit(vol), copy_unit(G), copy_unit(Gw)};
  kernel<<<(n_elem + TE - 1) / TE, S::K * TE, smem, s>>>(D, dphi, Hs, vol, G, Gw, n_elem, u);
  return cudaGetLastError();
}

// K3 for elements of shape S in tiles of `tile` elements (16, 32 or 64)
template <typename T, typename S>
int launch_contract_tile(const T* D, const T* dphi, const T* Hs, const T* vol,
                         T* G, T* Gw, int n_elem, int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_elem <= 0) return static_cast<int>(cudaSuccess);
  switch (tile) {
    case 16: return static_cast<int>(launch_contract<T, 16, S>(D, dphi, Hs, vol, G, Gw, n_elem, s));
    case 32: return static_cast<int>(launch_contract<T, 32, S>(D, dphi, Hs, vol, G, Gw, n_elem, s));
    case 64: return static_cast<int>(launch_contract<T, 64, S>(D, dphi, Hs, vol, G, Gw, n_elem, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K7 for elements of shape S
template <typename T, typename S>
int launch_contract_Gw(const T* Hs, const T* G, const T* vol, T* Gw, int n_elem,
                       void* stream) {
  if (n_elem <= 0) return static_cast<int>(cudaSuccess);
  constexpr int TE = kK7Tile;
  auto kernel = contract_Gw_kernel<T, TE, S>;
  const size_t smem = static_cast<size_t>(S::Vals) * TE * sizeof(T);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)  // opt in above the default 48 KB
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const K7Units u{copy_unit(Hs), copy_unit(G), copy_unit(vol), copy_unit(Gw)};
  kernel<<<(n_elem + TE - 1) / TE, S::K * TE, smem, static_cast<cudaStream_t>(stream)>>>(
      Hs, G, vol, Gw, n_elem, u);
  return static_cast<int>(cudaGetLastError());
}

// K1 for elements of K corners in DIM dimensions with N stretch values
template <typename T, int K, int DIM, int N>
int launch_element_apply(const int* tets, const T* gw, const T* mass, const T* free_mask,
                         const T* p, T* out, int n_elem, void* stream) {
  if (n_elem > 0)
    element_apply_kernel<T, K, DIM, N><<<blocks_for(n_elem), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        tets, gw, mass, free_mask, p, out, n_elem);
  return static_cast<int>(cudaGetLastError());
}

// K5 over the planes of `used` (bit o for plane o): the unrolled path for
// kK5Planes planes, else the runtime loop
template <typename T>
int launch_stencil_apply(const T* W, const T* x, const T* fm, T* y, int NI, int NJ, int NK,
                         int used, void* stream) {
  const long long npad = static_cast<long long>(NI + 2) * (NJ + 2) * (NK + 2);
  if (NI < 2 || NJ < 2 || NK < 2 || 9 * 27 * npad >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int NJp = NJ + 2, NKp = NK + 2;
  K5Planes p{};
  for (int o = 0; o < 27; ++o) {
    if (!((static_cast<unsigned>(used) >> o) & 1u)) continue;
    p.shift[p.n] = ((o / 9 - 1) * NJp + (o / 3 % 3 - 1)) * NKp + (o % 3 - 1);
    p.row[p.n] = 9 * o;
    ++p.n;
  }
  const dim3 grid(static_cast<unsigned>((npad + kK5Threads - 1) / kK5Threads), 3);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.n == kK5Planes)
    stencil_apply_kernel<T, kK5Planes><<<grid, kK5Threads, 0, s>>>(W, x, fm, y, NI, NJ, NK, p);
  else
    stencil_apply_kernel<T, 0><<<grid, kK5Threads, 0, s>>>(W, x, fm, y, NI, NJ, NK, p);
  return static_cast<int>(cudaGetLastError());
}

// K6 over nterms term rows and the schedule of sched_len values built from
// them: the zero planes first, then the tiles
template <typename T>
int launch_stencil_assemble(const T* gw, const T* mass, const int* terms, const int* plane_ptr,
                            const int* sched, T* W, int NI, int NJ, int NK, int nslots, int nterms,
                            int sched_len, void* stream) {
  const long long npad = static_cast<long long>(NI + 2) * (NJ + 2) * (NK + 2);
  constexpr K6Tile tl = k6_tile<T>();
  if (NI < 2 || NJ < 2 || NK < 2 || nslots < 1 || nslots > 255 || nterms < 0 ||
      sched_len < 5 + nterms || 9 * 27 * npad >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a cell's slots in shared memory take an odd number of values, so that
  // the cells of neighbouring threads start in different banks
  const int cs = 88 * nslots + (88 * nslots + 1) % 2;
  const size_t smem = ((static_cast<size_t>(16) * nterms + 4 * sched_len + 15) & ~static_cast<size_t>(15)) +
                      static_cast<size_t>(tl.TI + 1) * (tl.TJ + 1) * (tl.TK + 1) * cs * sizeof(T);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = stencil_assemble_kernel<T>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)  // opt in above the default 48 KB
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kVecN = 16 / sizeof(T);
  const long long plane = 9 * npad;
  const bool vec = reinterpret_cast<uintptr_t>(W) % 16 == 0 && plane % kVecN == 0;
  const dim3 zgrid(static_cast<unsigned>(std::min<long long>(64, (plane / kVecN + 255) / 256)), 27);
  if (vec)
    stencil_zero_planes_kernel<T, kVecN><<<zgrid, 256, 0, s>>>(plane_ptr, W, static_cast<int>(npad));
  else
    stencil_zero_planes_kernel<T, 1><<<zgrid, 256, 0, s>>>(plane_ptr, W, static_cast<int>(npad));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ntiles = ((NI + 2 + tl.TI - 1) / tl.TI) * static_cast<long long>((NJ + 2 + tl.TJ - 1) / tl.TJ) *
                           ((NK + 2 + tl.TK - 1) / tl.TK);
  kernel<<<static_cast<unsigned>(ntiles), tl.threads, smem, s>>>(
      gw, mass, terms, sched, W, NI, NJ, NK, nslots, nterms, sched_len, cs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* mf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// the entry points of one float type T, suffixed _f32 or _f64
#define MF_ENTRY_POINTS(T, SFX)                                                \
  int mf_element_apply_##SFX(const int* tets, const T* gw, const T* mass,     \
                             const T* free_mask, const T* p, T* out,          \
                             int n_elem, void* stream) {                      \
    return launch_element_apply<T, 4, 3, 6>(tets, gw, mass, free_mask, p, out, \
                                            n_elem, stream);                  \
  }                                                                            \
  int mf_element_apply_k3d2_##SFX(const int* tris, const T* gw, const T* mass, \
                                  const T* free_mask, const T* p, T* out,     \
                                  int n_elem, void* stream) {                 \
    return launch_element_apply<T, 3, 2, 3>(tris, gw, mass, free_mask, p, out, \
                                            n_elem, stream);                  \
  }                                                                            \
  int mf_element_apply_k3d3_##SFX(const int* tris, const T* gw, const T* mass, \
                                  const T* free_mask, const T* p, T* out,     \
                                  int n_elem, void* stream) {                 \
    return launch_element_apply<T, 3, 3, 6>(tris, gw, mass, free_mask, p, out, \
                                            n_elem, stream);                  \
  }                                                                            \
  int mf_element_apply_k2d3_##SFX(const int* segs, const T* gw, const T* mass, \
                                  const T* free_mask, const T* p, T* out,     \
                                  int n_elem, void* stream) {                 \
    return launch_element_apply<T, 2, 3, 6>(segs, gw, mass, free_mask, p, out, \
                                            n_elem, stream);                  \
  }                                                                            \
  int mf_contract_Gw_k3d3_##SFX(const T* Hs, const T* G, const T* vol, T* Gw,  \
                                int n_elem, void* stream) {                   \
    return launch_contract_Gw<T, K7Shape<3, 3, 6>>(Hs, G, vol, Gw, n_elem,     \
                                                   stream);                   \
  }                                                                            \
  int mf_contract_Gw_k2d3_##SFX(const T* Hs, const T* G, const T* vol, T* Gw,  \
                                int n_elem, void* stream) {                   \
    return launch_contract_Gw<T, K7Shape<2, 3, 6>>(Hs, G, vol, Gw, n_elem,     \
                                                   stream);                   \
  }                                                                            \
  int mf_contract_G_Gw_##SFX(const T* D, const T* dphi, const T* Hs,          \
                             const T* vol, T* G, T* Gw, int n_elem,           \
                             void* stream) {                                  \
    return launch_contract_tile<T, K3Tet>(D, dphi, Hs, vol, G, Gw, n_elem,    \
                                          kK3Tile, stream);                   \
  }                                                                            \
  int mf_contract_G_Gw_n3_##SFX(const T* D, const T* dphi, const T* Hs,       \
                                const T* vol, T* G, T* Gw, int n_elem,        \
                                void* stream) {                               \
    return launch_contract_tile<T, K3Tri>(D, dphi, Hs, vol, G, Gw, n_elem,    \
                                          kK3Tile, stream);                   \
  }                                                                            \
  int mf_contract_G_Gw_tile_##SFX(const T* D, const T* dphi, const T* Hs,     \
                                  const T* vol, T* G, T* Gw, int n_elem,      \
                                  int tile, void* stream) {                   \
    return launch_contract_tile<T, K3Tet>(D, dphi, Hs, vol, G, Gw, n_elem,    \
                                          tile, stream);                      \
  }                                                                            \
  int mf_segment_sum_##SFX(const int* row_ptr, const int* slots,              \
                           const int* piece_ptr, const int* seg_pieces,       \
                           const T* rows, T* part, T* out, int n_seg,         \
                           int n_pieces, int n_slots, int m, void* stream) {  \
    return launch_segment_sum<T>(false, row_ptr, slots, piece_ptr, seg_pieces, \
                                 rows, part, out, n_seg, n_pieces, n_slots,   \
                                 m, stream);                                  \
  }                                                                            \
  int mf_banded_sum_##SFX(const int* row_ptr, const int* slots,               \
                          const int* piece_ptr, const int* seg_pieces,        \
                          const T* rows, T* part, T* out, int nv,             \
                          int n_pieces, int n_slots, int m, void* stream) {   \
    return launch_segment_sum<T>(true, row_ptr, slots, piece_ptr, seg_pieces,  \
                                 rows, part, out, nv, n_pieces, n_slots, m,   \
                                 stream);                                     \
  }                                                                            \
  int mf_stencil_apply_##SFX(const T* W, const T* x, const T* fm, T* y,        \
                             int NI, int NJ, int NK, int used, void* stream) { \
    return launch_stencil_apply<T>(W, x, fm, y, NI, NJ, NK, used, stream);     \
  }                                                                            \
  int mf_stencil_assemble_##SFX(const T* gw, const T* mass, const int* terms,  \
                                const int* plane_ptr, const int* sched, T* W,  \
                                int NI, int NJ, int NK, int nslots,            \
                                int nterms, int sched_len, void* stream) {     \
    return launch_stencil_assemble<T>(gw, mass, terms, plane_ptr, sched, W,    \
                                      NI, NJ, NK, nslots, nterms, sched_len,   \
                                      stream);                                 \
  }

MF_ENTRY_POINTS(float, f32)
MF_ENTRY_POINTS(double, f64)

}  // extern "C"

// Hand-written Hopper (sm_90a) kernels of the mixed-stretch implicit step,
// unstructured (K1-K4) and on structured box grids (K5, K6). One
// translation unit with a plain C interface, built by
// mixedfem_tpu_torch/cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and loaded with ctypes. Every entry point launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError() of its launch.
// Each kernel is a template over float and double.
//
// K1 element_apply  replaces the gather/apply half of
//     mixedfem_tpu/ops/brick.py:_matvec_kernel (via _matvec_call,
//     brick_matvec). Per element e (one thread):
//       pe   = (free_mask * p)[T[e]]                 (4 corners x 3)
//       q    = Gw_e pe                                (6)
//       y_e  = Gw_e^T q + (M_e (x) I3) pe             (4 x 3, written out)
//     Bound: bytes. Gw (72), mass (16), T (4 ints) and y_e (12) per element,
//     ~42 MB at 100k tets f32, ~12.5 us at 3.35 TB/s; 384 flop/element is
//     negligible. Design: the per-element rows are streamed once, p and the
//     mask are gathered (they fit in L2), the sums stay in registers, and the
//     per-corner rows go to K2 for a deterministic vertex sum (no atomics).
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
//     3.35 TB/s; ~1.3 kflop/element is negligible. The first design (one
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
//     Design: a thread per (row a of y, lattice vertex), 83,076 threads at
//     100k tets (a thread per vertex, 27,692 threads on 132 SMs, took
//     22.2 us: too few loads in flight). W is feature-major with the vertex
//     minor, so each of a thread's 57 reads of W is coalesced across a warp
//     as it stands; the planes the plan never uses are skipped by a bit
//     mask, x[v + shift] comes from L1/L2 (the three rows of x are 0.33
//     MB), and a ghost vertex writes zeros without reading (its shifts
//     would leave the array). The sum runs over the planes in ascending
//     order, as the plain version adds them. Measured at 100k tets on an
//     NVIDIA H100 80GB HBM3 at 700 W: 17.7 us in f32 with W read from
//     device memory (3.0x its bound), 9.4 us with W in L2; 19.0 / 12.5 us
//     in f64 (bound 11.9 us).
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
//     TB/s. The kernel also writes the 8 zero planes (8.0 MB, about 2.4
//     us at that rate). Design: gather, no atomics. A block
//     takes 32 consecutive lattice vertices and all 27 planes (a warp per
//     plane); each thread walks its plane's terms in the plan's order, adds
//     the block of the one cell whose corner a sits at its vertex when that
//     cell exists and has the term's parity, and stores its 9 sums with
//     coalesced writes. The order of every sum is the plan's, so a run
//     repeats bit for bit. The 27 warps of a block read the same ~40
//     elements' rows, which L1 can serve after the first read. 52 registers
//     a thread in f32, 72 in f64, no spills. Measured at 100k tets on an
//     NVIDIA H100 80GB HBM3 at 700 W: 248 us in f32 (15x its bound), 471
//     us in f64 (bound 32.3 us): a warp's lanes read 32 elements 1,440
//     bytes apart (Gw is element-major), and the centre plane's warp adds
//     20 blocks at each vertex against about 3 for the others. Staging the
//     cell rows around a lattice line through shared memory is the next
//     design; it is 1.25 ms of a step that the host bounds at about 1 s.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
// K2 / K4: warps per block, rows per tile, widest row (two columns a lane)
constexpr int kSegWarps = 4;
constexpr int kTile = 32;
constexpr int kMaxWidth = 64;

template <typename T>
__global__ void element_apply_kernel(const int* __restrict__ tets,
                                     const T* __restrict__ gw,
                                     const T* __restrict__ mass,
                                     const T* __restrict__ free_mask,
                                     const T* __restrict__ p,
                                     T* __restrict__ out, int n_elem) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_elem) return;
  T pe[12];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int v = tets[4 * e + c];
    const T f = free_mask[v];
#pragma unroll
    for (int r = 0; r < 3; ++r) pe[3 * c + r] = f * p[3 * v + r];
  }
  const T* g = gw + 72 * static_cast<size_t>(e);
  T q[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T acc = T(0);
#pragma unroll
    for (int a = 0; a < 12; ++a) acc += g[12 * i + a] * pe[a];
    q[i] = acc;
  }
  const T* m = mass + 16 * static_cast<size_t>(e);
  T* y = out + 12 * static_cast<size_t>(e);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int a = 3 * c + r;
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < 6; ++i) acc += g[12 * i + a] * q[i];
#pragma unroll
      for (int l = 0; l < 4; ++l) acc += m[4 * c + l] * pe[3 * l + r];
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

// K3: values per element of D, dphi, Hs and of G (and Gw); a tile's spans
// lie in shared memory in the order D, dphi, Hs, vol, G, Gw
constexpr int kD = 54, kPhi = 12, kHs = 36, kG = 72;
constexpr int kK3Vals = kD + kPhi + kHs + 1 + 2 * kG;
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

// one block per tile of TE elements, a thread per (element, corner)
template <typename T, int TE>
__global__ void __launch_bounds__(4 * TE) contract_G_Gw_kernel(
    const T* __restrict__ D, const T* __restrict__ dphi,
    const T* __restrict__ Hs, const T* __restrict__ vol, T* __restrict__ G,
    T* __restrict__ Gw, int n_elem, K3Units u) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sD = reinterpret_cast<T*>(smem_raw);
  T* sPhi = sD + kD * TE;
  T* sHs = sPhi + kPhi * TE;
  T* sVol = sHs + kHs * TE;
  T* sG = sVol + TE;
  T* sGw = sG + kG * TE;
  const size_t e0 = static_cast<size_t>(blockIdx.x) * TE;
  const int n = min(TE, n_elem - static_cast<int>(e0));
  const int sz = static_cast<int>(sizeof(T));
  copy_span<T, true>(sD, D + kD * e0, kD * n * sz, u.D);
  copy_span<T, true>(sPhi, dphi + kPhi * e0, kPhi * n * sz, u.dphi);
  copy_span<T, true>(sHs, Hs + kHs * e0, kHs * n * sz, u.Hs);
  copy_span<T, true>(sVol, vol + e0, n * sz, u.vol);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int el = threadIdx.x >> 2, k = threadIdx.x & 3;
  if (el < n) {
    const T* d = sD + kD * el;
    T ph[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) ph[c] = sPhi[kPhi * el + 3 * k + c];
    T g[18];
    T* go = sG + kG * el + 3 * k;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        T acc = T(0);
#pragma unroll
        for (int c = 0; c < 3; ++c) acc += d[9 * i + 3 * r + c] * ph[c];
        g[3 * i + r] = acc;
        go[12 * i + r] = acc;
      }
    }
    const T sq = sqrt(sVol[el]);
    const T* h = sHs + kHs * el;
    T* wo = sGw + kG * el + 3 * k;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      T hi[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) hi[j] = h[6 * i + j];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < 6; ++j) acc += hi[j] * g[3 * j + r];
        wo[12 * i + r] = sq * acc;
      }
    }
  }
  __syncthreads();
  copy_span<T, false>(G + kG * e0, sG, kG * n * sz, u.G);
  copy_span<T, false>(Gw + kG * e0, sGw, kG * n * sz, u.Gw);
}

// K5: a thread per (row a of y, lattice vertex v) of the (NI+2, NJ+2, NK+2)
// lattice; blockIdx.y is a
template <typename T>
__global__ void stencil_apply_kernel(const T* __restrict__ W, const T* __restrict__ x,
                                     const T* __restrict__ fm, T* __restrict__ y,
                                     int NI, int NJ, int NK, unsigned used) {
  const int NJp = NJ + 2, NKp = NK + 2;
  const int npad = (NI + 2) * NJp * NKp;
  const int v = blockIdx.x * blockDim.x + threadIdx.x, a = blockIdx.y;
  if (v >= npad) return;
  const int k = v % NKp, j = (v / NKp) % NJp, i = v / (NJp * NKp);
  if (i == 0 || j == 0 || k == 0 || i == NI + 1 || j == NJ + 1 || k == NK + 1) {
    y[a * npad + v] = T(0);
    return;
  }
  T acc = T(0);
#pragma unroll
  for (int o = 0; o < 27; ++o) {
    if (!((used >> o) & 1u)) continue;
    const int u = v + ((o / 9 - 1) * NJp + (o / 3 % 3 - 1)) * NKp + (o % 3 - 1);
    const T* w = W + static_cast<size_t>(9 * o + 3 * a) * npad + v;
    acc += w[0] * x[u] + w[npad] * x[npad + u] + w[2 * npad] * x[2 * npad + u];
  }
  y[a * npad + v] = fm == nullptr ? acc : acc * fm[a * npad + v];
}

// K6: a block per 32 lattice vertices, a warp per plane (threadIdx.y)
constexpr int kK6Vertices = 32;

template <typename T>
__global__ void __launch_bounds__(kK6Vertices * 27) stencil_assemble_kernel(
    const T* __restrict__ gw, const T* __restrict__ mass, const int* __restrict__ terms,
    const int* __restrict__ plane_ptr, T* __restrict__ W, int NI, int NJ, int NK, int nslots) {
  const int NJp = NJ + 2, NKp = NK + 2;
  const int npad = (NI + 2) * NJp * NKp;
  const int NIc = NI - 1, NJc = NJ - 1, NKc = NK - 1;
  const int v = blockIdx.x * kK6Vertices + threadIdx.x, o = threadIdx.y;
  if (v >= npad) return;
  const int vk = v % NKp, vj = (v / NKp) % NJp, vi = v / (NJp * NKp);
  T acc[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) acc[q] = T(0);
  const int end = plane_ptr[o + 1];
  for (int q = plane_ptr[o]; q < end; ++q) {
    const int* tm = terms + 8 * q;  // slot, a, b, parity, ca (3), 0
    const int ci = vi - 1 - tm[4], cj = vj - 1 - tm[5], ck = vk - 1 - tm[6];
    if (ci < 0 || cj < 0 || ck < 0 || ci >= NIc || cj >= NJc || ck >= NKc) continue;
    if (((ci + cj + ck) & 1) != tm[3]) continue;
    const size_t e = static_cast<size_t>((ci * NJc + cj) * NKc + ck) * nslots + tm[0];
    const T* ga = gw + 72 * e + 3 * tm[1];
    const T* gb = gw + 72 * e + 3 * tm[2];
    T c[9];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int s = 0; s < 3; ++s) c[3 * r + s] = ga[r] * gb[s];
#pragma unroll
    for (int n = 1; n < 6; ++n)
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int s = 0; s < 3; ++s) c[3 * r + s] += ga[12 * n + r] * gb[12 * n + s];
    const T m = mass[16 * e + 4 * tm[1] + tm[2]];
    c[0] += m;
    c[4] += m;
    c[8] += m;
#pragma unroll
    for (int q2 = 0; q2 < 9; ++q2) acc[q2] += c[q2];
  }
  T* w = W + static_cast<size_t>(9 * o) * npad + v;
#pragma unroll
  for (int q = 0; q < 9; ++q) w[static_cast<size_t>(q) * npad] = acc[q];
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

template <typename T, int TE>
cudaError_t launch_contract(const T* D, const T* dphi, const T* Hs, const T* vol,
                            T* G, T* Gw, int n_elem, cudaStream_t s) {
  auto kernel = contract_G_Gw_kernel<T, TE>;
  const size_t smem = static_cast<size_t>(kK3Vals) * TE * sizeof(T);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)  // opt in above the default 48 KB
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const K3Units u{copy_unit(D), copy_unit(dphi), copy_unit(Hs), copy_unit(vol), copy_unit(G), copy_unit(Gw)};
  kernel<<<(n_elem + TE - 1) / TE, 4 * TE, smem, s>>>(D, dphi, Hs, vol, G, Gw, n_elem, u);
  return cudaGetLastError();
}

// K3 in tiles of `tile` elements (16, 32 or 64)
template <typename T>
int launch_contract_tile(const T* D, const T* dphi, const T* Hs, const T* vol,
                         T* G, T* Gw, int n_elem, int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_elem <= 0) return static_cast<int>(cudaSuccess);
  switch (tile) {
    case 16: return static_cast<int>(launch_contract<T, 16>(D, dphi, Hs, vol, G, Gw, n_elem, s));
    case 32: return static_cast<int>(launch_contract<T, 32>(D, dphi, Hs, vol, G, Gw, n_elem, s));
    case 64: return static_cast<int>(launch_contract<T, 64>(D, dphi, Hs, vol, G, Gw, n_elem, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_stencil_apply(const T* W, const T* x, const T* fm, T* y, int NI, int NJ, int NK,
                         int used, void* stream) {
  const long long npad = static_cast<long long>(NI + 2) * (NJ + 2) * (NK + 2);
  if (NI < 2 || NJ < 2 || NK < 2 || npad >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks_for(npad), 3);
  stencil_apply_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      W, x, fm, y, NI, NJ, NK, static_cast<unsigned>(used));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_stencil_assemble(const T* gw, const T* mass, const int* terms, const int* plane_ptr,
                            T* W, int NI, int NJ, int NK, int nslots, void* stream) {
  const long long npad = static_cast<long long>(NI + 2) * (NJ + 2) * (NK + 2);
  if (NI < 2 || NJ < 2 || NK < 2 || nslots < 1 || 9 * 27 * npad >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kK6Vertices, 27);
  stencil_assemble_kernel<T><<<static_cast<unsigned>((npad + kK6Vertices - 1) / kK6Vertices), block,
                               0, static_cast<cudaStream_t>(stream)>>>(gw, mass, terms, plane_ptr, W,
                                                                       NI, NJ, NK, nslots);
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
    if (n_elem > 0)                                                            \
      element_apply_kernel<T><<<blocks_for(n_elem), kThreads, 0,              \
                                static_cast<cudaStream_t>(stream)>>>(         \
          tets, gw, mass, free_mask, p, out, n_elem);                          \
    return static_cast<int>(cudaGetLastError());                               \
  }                                                                            \
  int mf_contract_G_Gw_##SFX(const T* D, const T* dphi, const T* Hs,          \
                             const T* vol, T* G, T* Gw, int n_elem,           \
                             void* stream) {                                  \
    return launch_contract_tile<T>(D, dphi, Hs, vol, G, Gw, n_elem, kK3Tile,  \
                                   stream);                                   \
  }                                                                            \
  int mf_contract_G_Gw_tile_##SFX(const T* D, const T* dphi, const T* Hs,     \
                                  const T* vol, T* G, T* Gw, int n_elem,      \
                                  int tile, void* stream) {                   \
    return launch_contract_tile<T>(D, dphi, Hs, vol, G, Gw, n_elem, tile,     \
                                   stream);                                   \
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
                                const int* plane_ptr, T* W, int NI, int NJ,    \
                                int NK, int nslots, void* stream) {            \
    return launch_stencil_assemble<T>(gw, mass, terms, plane_ptr, W, NI, NJ,   \
                                      NK, nslots, stream);                     \
  }

MF_ENTRY_POINTS(float, f32)
MF_ENTRY_POINTS(double, f64)

}  // extern "C"

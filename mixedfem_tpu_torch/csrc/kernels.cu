// Hand-written Hopper (sm_90a) kernels of the unstructured mixed-stretch
// implicit step. One translation unit with a plain C interface, built by
// mixedfem_tpu_torch/cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// and loaded with ctypes. Every entry point launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError() of its launch.
// Each kernel is a template over float (the benchmark's type) and double
// (the trajectory check).
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
//     _matvec_kernel. out[v, c] = sum over the slots j of segment v, in the
//     plan's fixed order, of rows[slots[j], c]; one thread per (segment,
//     column). Bound: bytes. rows (E*k*m), slots (E*k ints), row_ptr and
//     out: ~6.8 MB (m=3) / ~17 MB (m=9) at 100k tets f32, 2 us / 5 us.
//     Design: the static incidence plan (CSR of slot ids per vertex, built
//     once on the host) turns the scatter into a gather, so the sum is
//     deterministic and needs no atomics; neighbouring threads read
//     neighbouring columns of one row.
//
// K3 contract_G_Gw  replaces mixedfem_tpu/ops/smallops.py:_tr_kernel (via
//     _pallas_interleave, interleave_cols), the lane transpose that finishes
//     contract_D_dphi and contract_sym_G on the TPU. Per element e (one
//     thread):
//       G[i,k,r]  = sum_c D[i,r,c] dphi[k,c]              (6 x 4 x 3)
//       Gw[i,k,r] = sqrt(vol) sum_j Hs[i,j] G[j,k,r]
//     written row-major (E, 6, 4, 3) directly, so no transpose is needed.
//     Bound: bytes. D (54), dphi (12), Hs (36), vol (1) read and G, Gw
//     (144) written per element, ~99 MB at 100k tets f32, ~30 us;
//     ~1.3 kflop/element is negligible. It is a fused per-element pass that
//     Triton could also express; it lives here so that one nvcc call builds
//     the whole slice.
//
// K4 banded_sum  replaces mixedfem_tpu/ops/pallas_scatter.py:_make_kernel
//     (via _scatter_call, scatter_add_sorted), the windowed segment sum of
//     rows (Rp, m) in banded element order that carries banded_matvec and
//     the once-per-Newton assemblies of every loaded scene. out[v] = sum of
//     the rows whose vertex id is v. The TPU kernel keeps the whole (m,
//     nv_pad) output in VMEM across a sequential grid and adds each chunk's
//     one-hot product into a window of W vertices; here blocks run in no
//     order, and W depends on the mesh (896 on the banded 100k-tet beam,
//     22,400 when vertex ids are unordered), so a window in shared memory
//     would not fit. Two stages, both in a fixed order, no atomics:
//       stage 1 (banded_partial_kernel), one block per chunk of rows: the
//         chunk's rows (one contiguous run of chunk*m values) are copied
//         into shared memory with 16-byte loads, beside the chunk's slice
//         of the plan; then one thread per (distinct destination of the
//         chunk, column) sums that destination's rows in row order into a
//         partial. Shared memory depends on the chunk and m (2048 rows:
//         40 KB at m=3, 88 KB at m=9 in f32), not on W.
//       stage 2 (segment_sum_kernel, K2's code): per (vertex, column), the
//         partials of the chunks that touch the vertex, in chunk order.
//     The host plan (ops/banded_scatter.py) lists the partials and both
//     orders; the plain version adds in the same order.
//     Bound: bytes. rows (Rp*m), the plan's index arrays (grp_rows Rp ints,
//     vert_parts ~nv ints) and out (nv*m): ~7 MB at m=3 and ~16 MB at m=9
//     at 100k tets f32 (rows alone 4.8 / 14.4 MB), 2 / 5 us at 3.35 TB/s.
//     The partials (~nv*m, more where ids are unordered) make a round trip
//     through L2. One block per chunk gives 196 blocks at 100k tets, under
//     two per SM: each block's copy and sum are latency-bound, which is
//     what holds K4 above its bound.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kBandThreads = 512;
// most shared memory a block may opt into on Hopper (227 KB)
constexpr size_t kBandSmem = 227 * 1024;

// bytes of a stage-1 block's index arrays (chunk row ids, chunk+1 offsets),
// rounded up so that the rows after them are 16-byte aligned
__host__ __device__ inline size_t band_index_bytes(int chunk) {
  return ((2 * static_cast<size_t>(chunk) + 1) * sizeof(int) + 15) / 16 * 16;
}

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

template <typename T>
__global__ void segment_sum_kernel(const int* __restrict__ row_ptr,
                                   const int* __restrict__ slots,
                                   const T* __restrict__ rows,
                                   T* __restrict__ out, int n_seg, int m) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(n_seg) * m) return;
  const int v = static_cast<int>(idx / m);
  const int col = static_cast<int>(idx % m);
  T acc = T(0);
  const int end = row_ptr[v + 1];
  for (int j = row_ptr[v]; j < end; ++j)
    acc += rows[static_cast<size_t>(slots[j]) * m + col];
  out[idx] = acc;
}

template <typename T>
__global__ void contract_G_Gw_kernel(const T* __restrict__ D,
                                     const T* __restrict__ dphi,
                                     const T* __restrict__ Hs,
                                     const T* __restrict__ vol,
                                     T* __restrict__ G, T* __restrict__ Gw,
                                     int n_elem) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_elem) return;
  const size_t es = static_cast<size_t>(e);
  T ph[12];
#pragma unroll
  for (int a = 0; a < 12; ++a) ph[a] = dphi[12 * es + a];
  T g[72];
  const T* d = D + 54 * es;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        T acc = T(0);
#pragma unroll
        for (int c = 0; c < 3; ++c) acc += d[9 * i + 3 * r + c] * ph[3 * k + c];
        g[12 * i + 3 * k + r] = acc;
      }
    }
  }
  T* go = G + 72 * es;
#pragma unroll
  for (int a = 0; a < 72; ++a) go[a] = g[a];
  const T sq = sqrt(vol[es]);
  const T* h = Hs + 36 * es;
  T* wo = Gw + 72 * es;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T hi[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) hi[j] = h[6 * i + j];
#pragma unroll
    for (int a = 0; a < 12; ++a) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < 6; ++j) acc += hi[j] * g[12 * j + a];
      wo[12 * i + a] = sq * acc;
    }
  }
}

// Stage 1 of K4: block c sums the rows of chunk c per distinct destination.
// part[p, col] = sum over k in [grp_ptr[p], grp_ptr[p+1]) of
//   rows[c*chunk + grp_rows[k], col], for the partials p of chunk c.
// The chunk's rows own the grp entries [c*chunk, (c+1)*chunk), so the block
// stages its grp_rows and grp_ptr slices in shared memory beside all of its
// rows (16-byte copies when `vec`: the chunk's run of chunk*m values starts
// and ends 16-byte aligned); one thread per (partial, column) then sums
// with shared-memory reads only.
template <typename T>
__global__ void __launch_bounds__(kBandThreads)
banded_partial_kernel(const int* __restrict__ chunk_part_ptr,
                      const int* __restrict__ grp_ptr,
                      const int* __restrict__ grp_rows,
                      const T* __restrict__ rows, T* __restrict__ part,
                      int chunk, int m, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* s_rows = reinterpret_cast<int*>(smem_raw);  // chunk local row ids
  int* s_ptr = s_rows + chunk;                      // <= chunk+1 offsets
  T* tile = reinterpret_cast<T*>(smem_raw + band_index_bytes(chunk));
  const int c = blockIdx.x;
  const int row0 = c * chunk;
  const int p0 = chunk_part_ptr[c];
  const int np = chunk_part_ptr[c + 1] - p0;
  for (int i = threadIdx.x; i < chunk; i += blockDim.x)
    s_rows[i] = grp_rows[row0 + i];
  for (int i = threadIdx.x; i <= np; i += blockDim.x)
    s_ptr[i] = grp_ptr[p0 + i] - row0;
  const int n = chunk * m;
  const T* src = rows + static_cast<size_t>(row0) * m;
  if (vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* t4 = reinterpret_cast<uint4*>(tile);
    const int n4 = n / static_cast<int>(sizeof(uint4) / sizeof(T));
    for (int i = threadIdx.x; i < n4; i += blockDim.x) t4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = src[i];
  }
  __syncthreads();
  T* dst = part + static_cast<size_t>(p0) * m;
  for (int it = threadIdx.x; it < np * m; it += blockDim.x) {
    const int p = it / m;
    const int j = it - p * m;
    const int end = s_ptr[p + 1];
    T acc = T(0);
    for (int k = s_ptr[p]; k < end; ++k) acc += tile[s_rows[k] * m + j];
    dst[it] = acc;
  }
}

inline unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

template <typename T>
int launch_element_apply(const int* tets, const T* gw, const T* mass,
                         const T* free_mask, const T* p, T* out, int n_elem,
                         void* stream) {
  if (n_elem > 0)
    element_apply_kernel<T><<<blocks_for(n_elem), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        tets, gw, mass, free_mask, p, out, n_elem);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_segment_sum(const int* row_ptr, const int* slots, const T* rows,
                       T* out, int n_seg, int m, void* stream) {
  const long long n = static_cast<long long>(n_seg) * m;
  if (n > 0)
    segment_sum_kernel<T><<<blocks_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        row_ptr, slots, rows, out, n_seg, m);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_contract_G_Gw(const T* D, const T* dphi, const T* Hs, const T* vol,
                         T* G, T* Gw, int n_elem, void* stream) {
  if (n_elem > 0)
    contract_G_Gw_kernel<T><<<blocks_for(n_elem), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        D, dphi, Hs, vol, G, Gw, n_elem);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_banded_sum(const int* chunk_part_ptr, const int* grp_ptr,
                      const int* grp_rows, const int* vert_ptr,
                      const int* vert_parts, const T* rows, T* part, T* out,
                      int nchunks, int chunk, int nv, int m, void* stream) {
  if (chunk <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t row_bytes = static_cast<size_t>(chunk) * m * sizeof(T);
  const size_t smem = band_index_bytes(chunk) + row_bytes;
  if (smem > kBandSmem) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec =
      reinterpret_cast<uintptr_t>(rows) % 16 == 0 && row_bytes % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nchunks > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        banded_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    banded_partial_kernel<T><<<nchunks, kBandThreads, smem, s>>>(
        chunk_part_ptr, grp_ptr, grp_rows, rows, part, chunk, m, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long n = static_cast<long long>(nv) * m;
  if (n > 0)
    segment_sum_kernel<T><<<blocks_for(n), kThreads, 0, s>>>(
        vert_ptr, vert_parts, part, out, nv, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* mf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int mf_element_apply_f32(const int* tets, const float* gw, const float* mass,
                         const float* free_mask, const float* p, float* out,
                         int n_elem, void* stream) {
  return launch_element_apply<float>(tets, gw, mass, free_mask, p, out, n_elem,
                                     stream);
}

int mf_element_apply_f64(const int* tets, const double* gw,
                         const double* mass, const double* free_mask,
                         const double* p, double* out, int n_elem,
                         void* stream) {
  return launch_element_apply<double>(tets, gw, mass, free_mask, p, out,
                                      n_elem, stream);
}

int mf_segment_sum_f32(const int* row_ptr, const int* slots, const float* rows,
                       float* out, int n_seg, int m, void* stream) {
  return launch_segment_sum<float>(row_ptr, slots, rows, out, n_seg, m,
                                   stream);
}

int mf_segment_sum_f64(const int* row_ptr, const int* slots,
                       const double* rows, double* out, int n_seg, int m,
                       void* stream) {
  return launch_segment_sum<double>(row_ptr, slots, rows, out, n_seg, m,
                                    stream);
}

int mf_contract_G_Gw_f32(const float* D, const float* dphi, const float* Hs,
                         const float* vol, float* G, float* Gw, int n_elem,
                         void* stream) {
  return launch_contract_G_Gw<float>(D, dphi, Hs, vol, G, Gw, n_elem, stream);
}

int mf_contract_G_Gw_f64(const double* D, const double* dphi,
                         const double* Hs, const double* vol, double* G,
                         double* Gw, int n_elem, void* stream) {
  return launch_contract_G_Gw<double>(D, dphi, Hs, vol, G, Gw, n_elem, stream);
}

int mf_banded_sum_f32(const int* chunk_part_ptr, const int* grp_ptr,
                      const int* grp_rows, const int* vert_ptr,
                      const int* vert_parts, const float* rows, float* part,
                      float* out, int nchunks, int chunk, int nv, int m,
                      void* stream) {
  return launch_banded_sum<float>(chunk_part_ptr, grp_ptr, grp_rows, vert_ptr,
                                  vert_parts, rows, part, out, nchunks, chunk,
                                  nv, m, stream);
}

int mf_banded_sum_f64(const int* chunk_part_ptr, const int* grp_ptr,
                      const int* grp_rows, const int* vert_ptr,
                      const int* vert_parts, const double* rows, double* part,
                      double* out, int nchunks, int chunk, int nv, int m,
                      void* stream) {
  return launch_banded_sum<double>(chunk_part_ptr, grp_ptr, grp_rows, vert_ptr,
                                   vert_parts, rows, part, out, nchunks, chunk,
                                   nv, m, stream);
}

}  // extern "C"

// Launch plans of the thread-block cluster kernels (lstm.cu's seq and seq
// backward kernels, lstm2.cu's seq2 kernel): one cluster of `cluster` CTAs
// per tile of rows, clusters independent of each other.  The plan takes the
// fewest rows per tile (a multiple of the kernel's granularity) whose
// clusters the card holds at once, within the rows the kernel allows and the
// shared memory a block may use; past those limits, the most rows that fit
// them.  Plans are made once per (device, N, In, H) and cached, and the
// kernel's dynamic shared memory attribute is raised only when a shape needs
// more, so a launch after the first at a shape makes no runtime query.

#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

// A launch: `rows` rows per cluster, and the clusters the card holds at
// once at that launch (cudaOccupancyMaxActiveClusters).
struct ClusterPlan {
  dim3 grid, block;
  size_t smem;
  int rows;
  int max_clusters;
};

// What a tile costs one CTA of a kernel at one shape.  Rows per tile are a
// multiple of `granularity` and at most `rows_max`; each row takes
// `row_bytes` of dynamic shared memory on top of `fixed_bytes`, the CTA at
// least `min_smem`.
struct TileCost {
  int granularity;
  int rows_max;
  size_t row_bytes;
  size_t min_smem;
  size_t fixed_bytes = 0;
};

template <typename Kernel>
class ClusterPlanner {
 public:
  // `cost(In, H)`: the kernel's TileCost at a shape.  `threads(In, H,
  // rows)`: the threads a CTA of it takes for a tile of `rows` rows.  A
  // plan takes no more rows than the kernel's thread limit allows, unless
  // even the fewest exceed it; a CTA gets its threads in whole warps, at
  // most the limit.
  using Cost = TileCost (*)(int In, int H);
  using Threads = int (*)(int In, int H, int rows);

  ClusterPlanner(Kernel kernel, int cluster, Cost cost, Threads threads)
      : kernel_(kernel), cluster_(cluster), cost_(cost), threads_(threads) {}

  int cluster() const { return cluster_; }

  cudaLaunchConfig_t config(const ClusterPlan& plan, cudaStream_t stream,
                            cudaLaunchAttribute* attr) const {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = cluster_;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = plan.grid;
    config.blockDim = plan.block;
    config.dynamicSmemBytes = plan.smem;
    config.stream = stream;
    config.attrs = attr;
    config.numAttrs = 1;
    return config;
  }

  // The plan at (N, In, H) on the current device.  A shape that needs more
  // shared memory than the card offers fails at cudaFuncSetAttribute.
  cudaError_t plan(int N, int In, int H, ClusterPlan* plan) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mutex_);
    const auto key = std::make_tuple(dev, N, In, H);
    const auto it = plans_.find(key);
    if (it != plans_.end()) {
      *plan = it->second;
      return cudaSuccess;
    }
    err = make(dev, N, In, H, plan);
    if (err == cudaSuccess) plans_[key] = *plan;
    return err;
  }

 private:
  // Allows the kernel `smem` bytes of dynamic shared memory on `dev`.
  cudaError_t allow_smem(int dev, size_t smem) {
    size_t& allowed = smem_allowed_[dev];
    if (smem <= allowed) return cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute(
        kernel_, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) allowed = smem;
    return err;
  }

  // Called with mutex_ held.
  cudaError_t make(int dev, int N, int In, int H, ClusterPlan* plan) {
    int smem_optin = 0;
    cudaFuncAttributes fa;
    cudaError_t err = cudaDeviceGetAttribute(
        &smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel_);
    if (err != cudaSuccess) return err;
    const int max_threads = fa.maxThreadsPerBlock / 32 * 32;
    const TileCost c = cost_(In, H);
    const int g = c.granularity;
    const size_t room =
        (size_t)smem_optin > c.fixed_bytes ? smem_optin - c.fixed_bytes : 0;
    int r_max = (int)(room / c.row_bytes) / g * g;
    if (c.rows_max < r_max) r_max = c.rows_max;
    if (threads_(In, H, g) <= max_threads)
      while (r_max > g && threads_(In, H, r_max) > max_threads) r_max -= g;
    if (r_max < g) r_max = g;

    auto shape = [&](int R) {
      const int threads = threads_(In, H, R);
      plan->rows = R;
      plan->grid = dim3(((N + R - 1) / R) * cluster_);
      plan->block = dim3(threads >= max_threads ? max_threads
                                                : (threads + 31) / 32 * 32);
      const size_t need = c.fixed_bytes + c.row_bytes * R;
      plan->smem = need < c.min_smem ? c.min_smem : need;
      cudaError_t e = allow_smem(dev, plan->smem);
      if (e != cudaSuccess) return e;
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t config = this->config(*plan, nullptr, &attr);
      return cudaOccupancyMaxActiveClusters(&plan->max_clusters, kernel_,
                                            &config);
    };
    // the clusters the card holds at once: one CTA per SM (min_smem is more
    // than half an SM's shared memory), so the same for every R
    err = shape(g);
    if (err != cudaSuccess) return err;
    int R = g;
    while (R < r_max && (N + R - 1) / R > plan->max_clusters) R += g;
    return shape(R);  // and the count again at the launch's own threads
  }

  Kernel kernel_;
  int cluster_;
  Cost cost_;
  Threads threads_;
  std::mutex mutex_;
  std::map<std::tuple<int, int, int, int>, ClusterPlan> plans_;
  std::map<int, size_t> smem_allowed_;
};

}  // namespace

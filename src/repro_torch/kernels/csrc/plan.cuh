// Launch dimensions shared by each kernel's launcher and its exported
// <name>_plan function, so that the plan the Python wrapper certifies can
// be held against the grid, threads, dynamic shared memory and cluster the
// launcher really uses (chip_smoke.py does so for every shape it launches).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace plan {

struct Dims {
  dim3 grid;
  int threads;
  size_t smem;      // dynamic shared memory, bytes
  int cluster = 1;  // CTAs per thread-block cluster, along x
};

// The ints put writes per launch.
constexpr int kInts = 6;

// Writes d as six ints at out + 6 * k: grid x, y, z, threads, shared
// memory bytes, cluster size.
inline void put(int* out, int k, const Dims& d) {
  int* o = out + kInts * k;
  o[0] = static_cast<int>(d.grid.x);
  o[1] = static_cast<int>(d.grid.y);
  o[2] = static_cast<int>(d.grid.z);
  o[3] = d.threads;
  o[4] = static_cast<int>(d.smem);
  o[5] = d.cluster;
}

}  // namespace plan

// The thread count of pool.cu's floor_kernel (one block per stream).

#pragma once

namespace {

constexpr int THREADS = 256;

}  // namespace

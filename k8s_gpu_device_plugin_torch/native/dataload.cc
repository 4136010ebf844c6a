// Native data loader: parallel gather of token windows from a packed
// corpus, the C++ side of data/native_loader.py.
//
// Port of k8s_gpu_device_plugin_tpu/native/dataload.cc (the same C
// interface and the same gather). The Python MemmapSource slices B windows
// from an np.memmap serially on the main thread: on a cold corpus every
// slice is a chain of page faults, and the uint16 -> int32 widening runs
// single-threaded. This library maps the file once and gathers all B
// windows with a worker pool (page faults overlap across threads, the
// widening is parallel) into one caller-owned contiguous int32 buffer:
// the array the trainer's DataLoader pins and copies to the card.
//
// Dependency-free C++17 and POSIX (mmap), built at first use by
// data/native_loader.py and bound with ctypes. The windows are (start,
// len) pairs the Python side computes, so the deterministic sampling
// recipe stays in one place and the native batches equal the Python
// source's bit for bit.

#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <thread>
#include <vector>

namespace {

struct Corpus {
  const uint8_t* base = nullptr;  // mmap'ed file
  size_t bytes = 0;
  int fd = -1;
  int dtype_code = 0;  // 2 = uint16, 4 = uint32 (element width in bytes)
};

size_t elem_width(int dtype_code) { return static_cast<size_t>(dtype_code); }

}  // namespace

extern "C" {

// Open a packed token file. dtype_code: 2 (uint16) or 4 (uint32).
// Returns an opaque handle (heap pointer) or null on failure.
void* dataload_open(const char* path, int dtype_code) {
  if (dtype_code != 2 && dtype_code != 4) return nullptr;
  int fd = ::open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size <= 0) {
    ::close(fd);
    return nullptr;
  }
  void* map = ::mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                     MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  // Access is random-start windows: telling the kernel WILLNEED over the
  // whole mapping would queue readahead of the entire (possibly TB-scale)
  // file and thrash page cache. Disable whole-file readahead; each gather
  // schedules WILLNEED for exactly the windows it is about to touch.
  ::madvise(map, static_cast<size_t>(st.st_size), MADV_RANDOM);
  auto* c = new Corpus();
  c->base = static_cast<const uint8_t*>(map);
  c->bytes = static_cast<size_t>(st.st_size);
  c->fd = fd;
  c->dtype_code = dtype_code;
  return c;
}

// Number of tokens in the corpus (0 on null handle).
int64_t dataload_len(void* handle) {
  if (handle == nullptr) return 0;
  auto* c = static_cast<Corpus*>(handle);
  return static_cast<int64_t>(c->bytes / elem_width(c->dtype_code));
}

// Gather n_rows windows of row_len tokens each, widening to int32.
// starts[i] is a TOKEN offset; every window [starts[i], starts[i]+row_len)
// must lie inside the corpus — returns the number of rows gathered
// (== n_rows on success; 0 on any out-of-range row, leaving `out`
// unspecified). `threads` <= 0 picks a default.
int32_t dataload_gather(void* handle, const int64_t* starts, int32_t n_rows,
                        int32_t row_len, int32_t* out, int32_t threads) {
  if (handle == nullptr || starts == nullptr || out == nullptr ||
      n_rows <= 0 || row_len <= 0) {
    return 0;
  }
  auto* c = static_cast<Corpus*>(handle);
  const int64_t n_tokens = dataload_len(handle);
  for (int32_t i = 0; i < n_rows; ++i) {
    if (starts[i] < 0 || starts[i] + row_len > n_tokens) return 0;
  }
  // Schedule readahead for exactly the windows this gather touches (the
  // mapping itself is MADV_RANDOM, so the kernel won't read ahead on its
  // own). madvise wants page-aligned starts; lengths may be unaligned.
  {
    const long page = ::sysconf(_SC_PAGESIZE);
    const size_t pmask = page > 0 ? static_cast<size_t>(page) - 1 : 4095;
    const size_t width = elem_width(c->dtype_code);
    for (int32_t i = 0; i < n_rows; ++i) {
      const size_t lo = static_cast<size_t>(starts[i]) * width;
      const size_t hi = lo + static_cast<size_t>(row_len) * width;
      const size_t alo = lo & ~pmask;
      ::madvise(const_cast<uint8_t*>(c->base) + alo, hi - alo, MADV_WILLNEED);
    }
  }
  int nthreads = threads > 0 ? threads
                             : static_cast<int>(
                                   std::thread::hardware_concurrency());
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n_rows) nthreads = n_rows;
  if (nthreads > 16) nthreads = 16;

  std::atomic<int32_t> next{0};
  auto worker = [&]() {
    for (;;) {
      const int32_t i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= n_rows) return;
      int32_t* dst = out + static_cast<size_t>(i) * row_len;
      const size_t off = static_cast<size_t>(starts[i]);
      if (c->dtype_code == 2) {
        const uint16_t* src =
            reinterpret_cast<const uint16_t*>(c->base) + off;
        for (int32_t j = 0; j < row_len; ++j) dst[j] = src[j];
      } else {
        const uint32_t* src =
            reinterpret_cast<const uint32_t*>(c->base) + off;
        for (int32_t j = 0; j < row_len; ++j) {
          dst[j] = static_cast<int32_t>(src[j]);
        }
      }
    }
  };
  if (nthreads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return n_rows;
}

void dataload_close(void* handle) {
  if (handle == nullptr) return;
  auto* c = static_cast<Corpus*>(handle);
  ::munmap(const_cast<uint8_t*>(c->base), c->bytes);
  ::close(c->fd);
  delete c;
}

}  // extern "C"

// SRPack reader: memory-mapped multi-resolution image shards, read in
// batches by a pool of threads (the port's own copy of the JAX package's
// native reader; same layout, same C interface).
//
// One mmap'd file holds every image at every resolution behind a flat
// (offset, length) index; a batched read copies the records of a batch
// straight from the page cache into one contiguous host buffer.
//
// Layout (little-endian):
//   magic   'SRPK'            (4 bytes)
//   version uint32 = 1
//   codec   uint32            (0 = raw u8 HWC, 1 = jpeg bytes)
//   n_sizes uint32
//   n_items uint64
//   sizes   uint32  * n_sizes
//   index   (uint64 offset, uint64 length) * n_sizes * n_items
//   blob    bytes
//
// Exposed as a C ABI for ctypes. Thread-safe for concurrent batch reads.
// Built with g++ at first use by ops/_build.py.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Header {
    char magic[4];
    uint32_t version;
    uint32_t codec;
    uint32_t n_sizes;
    uint64_t n_items;
};

struct Pack {
    int fd = -1;
    const uint8_t* base = nullptr;
    size_t file_size = 0;
    uint32_t codec = 0;
    std::vector<uint32_t> sizes;
    uint64_t n_items = 0;
    // index[size_idx * n_items + item] -> (offset, length)
    const uint64_t* index = nullptr;
    const uint8_t* blob = nullptr;
};

int hw_threads() {
    unsigned n = std::thread::hardware_concurrency();
    return n ? static_cast<int>(n) : 4;
}

}  // namespace

extern "C" {

void* srpack_open(const char* path) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
    void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
    if (base == MAP_FAILED) { ::close(fd); return nullptr; }
    madvise(base, st.st_size, MADV_WILLNEED);

    const uint8_t* p = static_cast<const uint8_t*>(base);
    Header h;
    std::memcpy(&h, p, sizeof(Header));
    if (std::memcmp(h.magic, "SRPK", 4) != 0 || h.version != 1) {
        munmap(base, st.st_size);
        ::close(fd);
        return nullptr;
    }
    auto* pk = new Pack();
    pk->fd = fd;
    pk->base = p;
    pk->file_size = st.st_size;
    pk->codec = h.codec;
    pk->n_items = h.n_items;
    pk->sizes.resize(h.n_sizes);
    size_t off = sizeof(Header);
    std::memcpy(pk->sizes.data(), p + off, h.n_sizes * sizeof(uint32_t));
    off += h.n_sizes * sizeof(uint32_t);
    pk->index = reinterpret_cast<const uint64_t*>(p + off);
    off += size_t(h.n_sizes) * h.n_items * 2 * sizeof(uint64_t);
    pk->blob = p + off;
    return pk;
}

void srpack_close(void* handle) {
    auto* pk = static_cast<Pack*>(handle);
    if (!pk) return;
    munmap(const_cast<uint8_t*>(pk->base), pk->file_size);
    ::close(pk->fd);
    delete pk;
}

uint64_t srpack_n_items(void* handle) {
    return static_cast<Pack*>(handle)->n_items;
}

uint32_t srpack_codec(void* handle) {
    return static_cast<Pack*>(handle)->codec;
}

uint32_t srpack_n_sizes(void* handle) {
    return static_cast<Pack*>(handle)->sizes.size();
}

void srpack_sizes(void* handle, uint32_t* out) {
    auto* pk = static_cast<Pack*>(handle);
    std::memcpy(out, pk->sizes.data(), pk->sizes.size() * sizeof(uint32_t));
}

uint64_t srpack_record_length(void* handle, uint32_t size_idx, uint64_t item) {
    auto* pk = static_cast<Pack*>(handle);
    return pk->index[(size_t(size_idx) * pk->n_items + item) * 2 + 1];
}

// Copy one record's bytes. Returns copied length (<= cap).
uint64_t srpack_read_record(void* handle, uint32_t size_idx, uint64_t item,
                            uint8_t* out, uint64_t cap) {
    auto* pk = static_cast<Pack*>(handle);
    const uint64_t* e = pk->index + (size_t(size_idx) * pk->n_items + item) * 2;
    uint64_t n = e[1] < cap ? e[1] : cap;
    std::memcpy(out, pk->blob + e[0], n);
    return n;
}

// Gather a fixed-stride batch (raw codec): out[i*stride : i*stride+len_i].
// Parallelized over items with a thread pool. Returns 0 on success.
int srpack_read_batch(void* handle, uint32_t size_idx, const int64_t* items,
                      int n, uint8_t* out, uint64_t stride) {
    auto* pk = static_cast<Pack*>(handle);
    if (size_idx >= pk->sizes.size()) return -1;
    std::atomic<int> next(0);
    int n_threads = hw_threads();
    if (n_threads > n) n_threads = n;
    std::vector<std::thread> workers;
    std::atomic<int> bad(0);
    for (int t = 0; t < n_threads; ++t) {
        workers.emplace_back([&]() {
            for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
                int64_t item = items[i];
                if (item < 0 || uint64_t(item) >= pk->n_items) { bad.store(1); continue; }
                const uint64_t* e =
                    pk->index + (size_t(size_idx) * pk->n_items + item) * 2;
                uint64_t len = e[1] < stride ? e[1] : stride;
                std::memcpy(out + uint64_t(i) * stride, pk->blob + e[0], len);
            }
        });
    }
    for (auto& w : workers) w.join();
    return bad.load() ? -2 : 0;
}

}  // extern "C"

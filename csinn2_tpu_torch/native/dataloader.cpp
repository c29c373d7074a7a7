// Native threaded data loader (C++ runtime component) — the port's copy of
// csinn2_tpu/native/dataloader.cpp, built by runtime/dataloader.py with g++
// at first use.
//
// Analog of the reference's host-side input feeding: HHB-emitted mains read
// raw image tensors from disk before csinn_session_run (ref:
// example/c906_mobilenetv1_f16.c main — get_binary_from_file + loop).  An
// accelerator needs its host to keep it fed, so this loader adds what a
// single-core C library never needed: a background prefetch thread that
// mmaps a raw sample archive and stages ready-made batches in a bounded
// queue, overlapping disk/page-cache reads with device execution.
//
// Archive format: flat little-endian f32 samples [n_samples, sample_floats]
// (a .npy payload without the header — producers write it with
// numpy.tofile).  C ABI for the Python ctypes binding (runtime/dataloader.py).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Loader {
    int fd = -1;
    const float* data = nullptr;     // mmap'd archive
    uint64_t file_bytes = 0;
    uint64_t n_samples = 0;
    uint64_t sample_floats = 0;
    uint64_t batch = 0;
    bool loop = false;

    std::deque<std::vector<float>> queue;
    uint64_t next_sample = 0;        // producer cursor
    uint64_t max_queue = 4;
    std::mutex mu;
    std::condition_variable cv_can_produce, cv_can_consume;
    std::thread worker;
    std::atomic<bool> stop{false};
    bool exhausted = false;

    void produce_loop() {
        for (;;) {
            std::vector<float> buf(batch * sample_floats);
            uint64_t produced = 0;
            {
                // reserve the sample range under the lock, copy outside it
                std::unique_lock<std::mutex> lk(mu);
                if (stop.load()) return;
                if (next_sample >= n_samples && !loop) {
                    exhausted = true;
                    cv_can_consume.notify_all();
                    return;
                }
            }
            for (uint64_t i = 0; i < batch; ++i) {
                uint64_t s;
                {
                    std::unique_lock<std::mutex> lk(mu);
                    if (next_sample >= n_samples) {
                        if (!loop) break;
                        next_sample = 0;
                    }
                    s = next_sample++;
                }
                std::memcpy(buf.data() + i * sample_floats,
                            data + s * sample_floats,
                            sample_floats * sizeof(float));
                ++produced;
            }
            if (produced == 0) {
                std::unique_lock<std::mutex> lk(mu);
                exhausted = true;
                cv_can_consume.notify_all();
                return;
            }
            buf.resize(produced * sample_floats);
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_can_produce.wait(lk, [&] {
                    return stop.load() || queue.size() < max_queue;
                });
                if (stop.load()) return;
                queue.emplace_back(std::move(buf));
                cv_can_consume.notify_one();
            }
        }
    }
};

}  // namespace

extern "C" {

// Open an archive of n_samples × sample_floats f32 values.  batch = samples
// per dl_next; loop=1 wraps around forever; prefetch_depth bounds the queue.
void* dl_open(const char* path, uint64_t sample_floats, uint64_t batch,
              int loop, uint64_t prefetch_depth) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
    uint64_t bytes = (uint64_t)st.st_size;
    uint64_t sample_bytes = sample_floats * sizeof(float);
    if (sample_bytes == 0 || bytes % sample_bytes != 0) { ::close(fd); return nullptr; }
    void* map = mmap(nullptr, bytes, PROT_READ, MAP_PRIVATE, fd, 0);
    if (map == MAP_FAILED) { ::close(fd); return nullptr; }
    ::madvise(map, bytes, MADV_SEQUENTIAL);

    auto* ld = new Loader();
    ld->fd = fd;
    ld->data = reinterpret_cast<const float*>(map);
    ld->file_bytes = bytes;
    ld->sample_floats = sample_floats;
    ld->n_samples = bytes / sample_bytes;
    ld->batch = batch;
    ld->loop = loop != 0;
    ld->max_queue = prefetch_depth ? prefetch_depth : 4;
    ld->worker = std::thread([ld] { ld->produce_loop(); });
    return ld;
}

uint64_t dl_n_samples(void* h) {
    return h ? static_cast<Loader*>(h)->n_samples : 0;
}

// Fill out[batch * sample_floats]; returns samples delivered (0 = exhausted).
uint64_t dl_next(void* h, float* out) {
    auto* ld = static_cast<Loader*>(h);
    std::vector<float> buf;
    {
        std::unique_lock<std::mutex> lk(ld->mu);
        ld->cv_can_consume.wait(lk, [&] {
            return !ld->queue.empty() || ld->exhausted || ld->stop.load();
        });
        if (ld->queue.empty()) return 0;
        buf = std::move(ld->queue.front());
        ld->queue.pop_front();
        ld->cv_can_produce.notify_one();
    }
    std::memcpy(out, buf.data(), buf.size() * sizeof(float));
    return buf.size() / ld->sample_floats;
}

void dl_close(void* h) {
    auto* ld = static_cast<Loader*>(h);
    if (!ld) return;
    {
        std::unique_lock<std::mutex> lk(ld->mu);
        ld->stop.store(true);
        ld->cv_can_produce.notify_all();
        ld->cv_can_consume.notify_all();
    }
    if (ld->worker.joinable()) ld->worker.join();
    if (ld->data) munmap(const_cast<float*>(ld->data), ld->file_bytes);
    if (ld->fd >= 0) ::close(ld->fd);
    delete ld;
}

}  // extern "C"

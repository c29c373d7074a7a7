// CTBM — csinn2_tpu binary model format (C++ runtime component); the port's
// copy of csinn2_tpu/native/bmfmt.cpp, built by csinn2_tpu_torch/runtime/bm.py.
//
// TPU-native re-design of the reference's HHB binary model
// (ref: shl_bm_header_str "HHB binary model v2.0", source/nn2/format.c:23;
// section table struct shl_binary_model_section_info, include/shl_utils.h:93-106;
// 4096-aligned sections written during session setup,
// source/graph_ref/setup.c:735).
//
// Layout:
//   [0, 4096)    header: magic "CTBM.TPUv1\0", counts, section-table offset
//   [4096, ...)  section table: fixed-size entries (name, dtype, ndim, shape,
//                offset, nbytes)
//   ...          payload sections, each 4096-aligned (mmap/odirect friendly)
//
// The loader mmaps the file and hands out zero-copy pointers — the analog of
// the reference's mmap'd LLM weight blob (source/llm/llm_json.cpp:38-57).
// Exposed as a C ABI for Python ctypes binding (runtime/bm.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[12] = "CTBM.TPUv1";
constexpr uint64_t kAlign = 4096;
constexpr int kMaxName = 192;
constexpr int kMaxDims = 8;

struct Header {
    char magic[12];
    uint32_t version;
    uint64_t n_sections;
    uint64_t table_offset;
    uint64_t total_size;
    char pad[4096 - 12 - 4 - 8 * 3];
};
static_assert(sizeof(Header) == 4096, "header must be one page");

struct SectionEntry {
    char name[kMaxName];
    int32_t dtype;            // numpy-style type char + itemsize packed by caller
    int32_t ndim;
    int64_t shape[kMaxDims];
    uint64_t offset;          // absolute file offset, 4096-aligned
    uint64_t nbytes;
};

uint64_t align_up(uint64_t x) { return (x + kAlign - 1) / kAlign * kAlign; }

struct Writer {
    FILE* f = nullptr;
    SectionEntry* entries = nullptr;
    uint64_t cap = 0, count = 0;
    uint64_t cursor = 0;      // next payload offset
};

struct Reader {
    int fd = -1;
    void* base = nullptr;
    uint64_t size = 0;
    const Header* hdr = nullptr;
    const SectionEntry* table = nullptr;
};

}  // namespace

extern "C" {

// ---------- writer ----------

void* ctbm_writer_open(const char* path, uint64_t max_sections) {
    Writer* w = new Writer();
    w->f = fopen(path, "wb");
    if (!w->f) { delete w; return nullptr; }
    w->cap = max_sections;
    w->entries = (SectionEntry*)calloc(max_sections, sizeof(SectionEntry));
    uint64_t table_bytes = align_up(max_sections * sizeof(SectionEntry));
    w->cursor = sizeof(Header) + table_bytes;
    return w;
}

int ctbm_writer_add(void* wp, const char* name, int32_t dtype, int32_t ndim,
                    const int64_t* shape, const void* data, uint64_t nbytes) {
    Writer* w = (Writer*)wp;
    if (!w || w->count >= w->cap || ndim > kMaxDims) return -1;
    SectionEntry* e = &w->entries[w->count];
    snprintf(e->name, kMaxName, "%s", name);
    e->dtype = dtype;
    e->ndim = ndim;
    for (int i = 0; i < ndim; i++) e->shape[i] = shape[i];
    e->offset = w->cursor;
    e->nbytes = nbytes;
    if (fseek(w->f, (long)e->offset, SEEK_SET) != 0) return -2;
    if (fwrite(data, 1, nbytes, w->f) != nbytes) return -3;
    w->cursor = align_up(e->offset + nbytes);
    w->count++;
    return 0;
}

int ctbm_writer_close(void* wp) {
    Writer* w = (Writer*)wp;
    if (!w) return -1;
    Header h;
    memset(&h, 0, sizeof(h));
    memcpy(h.magic, kMagic, sizeof(kMagic));
    h.version = 1;
    h.n_sections = w->count;
    h.table_offset = sizeof(Header);
    h.total_size = w->cursor;
    int rc = 0;
    if (fseek(w->f, 0, SEEK_SET) != 0 ||
        fwrite(&h, sizeof(h), 1, w->f) != 1 ||
        fseek(w->f, (long)h.table_offset, SEEK_SET) != 0 ||
        fwrite(w->entries, sizeof(SectionEntry), w->count, w->f) != w->count) {
        rc = -2;
    }
    fclose(w->f);
    free(w->entries);
    delete w;
    return rc;
}

// ---------- reader (mmap, zero-copy) ----------

void* ctbm_open(const char* path) {
    Reader* r = new Reader();
    r->fd = open(path, O_RDONLY);
    if (r->fd < 0) { delete r; return nullptr; }
    struct stat st;
    if (fstat(r->fd, &st) != 0) { close(r->fd); delete r; return nullptr; }
    r->size = (uint64_t)st.st_size;
    r->base = mmap(nullptr, r->size, PROT_READ, MAP_PRIVATE, r->fd, 0);
    if (r->base == MAP_FAILED) { close(r->fd); delete r; return nullptr; }
    r->hdr = (const Header*)r->base;
    if (memcmp(r->hdr->magic, kMagic, sizeof(kMagic)) != 0 ||
        r->hdr->version != 1) {
        munmap(r->base, r->size); close(r->fd); delete r; return nullptr;
    }
    r->table = (const SectionEntry*)((const char*)r->base + r->hdr->table_offset);
    return r;
}

uint64_t ctbm_n_sections(void* rp) {
    Reader* r = (Reader*)rp;
    return r ? r->hdr->n_sections : 0;
}

// Fills caller buffers; returns pointer into the mmap (zero-copy) or null.
const void* ctbm_section(void* rp, uint64_t idx, char* name_out,
                         int32_t* dtype_out, int32_t* ndim_out,
                         int64_t* shape_out, uint64_t* nbytes_out) {
    Reader* r = (Reader*)rp;
    if (!r || idx >= r->hdr->n_sections) return nullptr;
    const SectionEntry* e = &r->table[idx];
    snprintf(name_out, kMaxName, "%s", e->name);
    *dtype_out = e->dtype;
    *ndim_out = e->ndim;
    for (int i = 0; i < e->ndim; i++) shape_out[i] = e->shape[i];
    *nbytes_out = e->nbytes;
    return (const char*)r->base + e->offset;
}

void ctbm_close(void* rp) {
    Reader* r = (Reader*)rp;
    if (!r) return;
    munmap(r->base, r->size);
    close(r->fd);
    delete r;
}

}  // extern "C"

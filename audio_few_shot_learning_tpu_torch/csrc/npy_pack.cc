// Native dataset packer: parallel .npy -> packed normalized store.
//
// The PyTorch package's own copy of the JAX package's native/npy_pack.cc,
// with the same C ABI, so the two packages write the same bytes. Building a
// packed split from thousands of per-item .npy files is the data layer's
// cold path; here a thread pool parses each npy header (v1/v2, little-endian
// f4/f8, C order), streams the payload, z-normalizes it with the dataset's
// global statistics, (x - mean) * inv_std, and writes it straight into the
// preallocated packed buffer, as float32 or as bfloat16 (round to nearest
// even). Host code: built with g++ (not nvcc) at first use and loaded with
// ctypes by audio_few_shot_learning_tpu_torch/data/native_pack.py.
//
// Reference counterpart: datasets/datasets.py:48-64 (np.load + z-norm per
// item inside the training loop); here it runs once, at pack time.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <sys/stat.h>

namespace {

struct NpyInfo {
  int64_t elems = 0;       // total element count
  int64_t shape0 = 1;      // leading dim (segment count for stacked specs)
  bool f64 = false;        // '<f8' payload (else '<f4')
  int64_t data_offset = 0; // byte offset of payload
  bool ok = false;
};

// Minimal npy header parser (format spec v1.0/v2.0).
NpyInfo parse_header(FILE* f) {
  NpyInfo info;
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return info;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return info;
  int major = magic[6];
  uint32_t hlen = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return info;
    hlen = b[0] | (b[1] << 8);
    info.data_offset = 10 + hlen;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return info;
    hlen = b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
    info.data_offset = 12 + hlen;
  }
  std::string hdr(hlen, '\0');
  if (fread(&hdr[0], 1, hlen, f) != hlen) return info;

  auto find_val = [&](const char* key) -> std::string {
    size_t p = hdr.find(key);
    if (p == std::string::npos) return "";
    p = hdr.find(':', p);
    if (p == std::string::npos) return "";
    return hdr.substr(p + 1, 64);
  };

  std::string descr = find_val("'descr'");
  if (descr.find("<f4") != std::string::npos) {
    info.f64 = false;
  } else if (descr.find("<f8") != std::string::npos) {
    info.f64 = true;
  } else {
    return info;  // unsupported dtype
  }
  if (find_val("'fortran_order'").find("True") != std::string::npos) return info;

  size_t sp = hdr.find("'shape'");
  if (sp == std::string::npos) return info;
  size_t lp = hdr.find('(', sp), rp = hdr.find(')', sp);
  if (lp == std::string::npos || rp == std::string::npos) return info;
  std::string shape = hdr.substr(lp + 1, rp - lp - 1);
  int64_t elems = 1, dim = 0, ndims = 0;
  bool have_digit = false;
  for (char c : shape) {
    if (c >= '0' && c <= '9') {
      dim = dim * 10 + (c - '0');
      have_digit = true;
    } else if (c == ',') {
      if (have_digit) {
        if (ndims == 0) info.shape0 = dim;
        elems *= dim;
        ++ndims;
      }
      dim = 0;
      have_digit = false;
    }
  }
  if (have_digit) {
    if (ndims == 0) info.shape0 = dim;
    elems *= dim;
    ++ndims;
  }
  // shape0 is the SEGMENT count: stacked specs are 3-D [S, F, T]; 1-D
  // waveforms and 2-D [F, T] single-segment specs (the offline to_spec
  // layout) are one logical segment, so a fixed-length spec dataset passes
  // the loader's elems == segs * F * T check.
  if (ndims <= 2) info.shape0 = 1;
  info.elems = elems;
  info.ok = true;
  return info;
}

// float -> bfloat16 with round-to-nearest-even (as torch and ml_dtypes convert).
inline uint16_t f32_to_bf16(float v) {
  uint32_t x;
  memcpy(&x, &v, 4);
  if ((x & 0x7FFFFFFFu) > 0x7F800000u) {  // NaN: keep quiet, don't round to Inf
    return (uint16_t)((x >> 16) | 0x0040u);
  }
  x += 0x7FFFu + ((x >> 16) & 1u);  // round-to-nearest-even on bit 16
  return (uint16_t)(x >> 16);
}

struct WriteF32 {
  void operator()(float* out, int64_t i, float v) const { out[i] = v; }
  using Out = float;
};
struct WriteBF16 {
  void operator()(uint16_t* out, int64_t i, float v) const {
    out[i] = f32_to_bf16(v);
  }
  using Out = uint16_t;
};

// Read one file's payload into out, normalized and converted by Writer.
// Returns elems read or -1 on failure.
template <typename Writer>
int64_t load_one(const char* path, typename Writer::Out* out, int64_t capacity,
                 float mean, float inv_std) {
  Writer write;
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  NpyInfo info = parse_header(f);
  if (!info.ok || info.elems > capacity) {
    fclose(f);
    return -1;
  }
  fseek(f, (long)info.data_offset, SEEK_SET);
  const size_t kChunk = 1 << 16;
  int64_t done = 0;
  if (!info.f64) {
    std::vector<float> buf(kChunk);
    while (done < info.elems) {
      size_t want = (size_t)std::min<int64_t>(kChunk, info.elems - done);
      size_t got = fread(buf.data(), 4, want, f);
      if (got == 0) break;
      for (size_t i = 0; i < got; ++i)
        write(out, done + i, (buf[i] - mean) * inv_std);
      done += (int64_t)got;
    }
  } else {
    std::vector<double> buf(kChunk);
    while (done < info.elems) {
      size_t want = (size_t)std::min<int64_t>(kChunk, info.elems - done);
      size_t got = fread(buf.data(), 8, want, f);
      if (got == 0) break;
      for (size_t i = 0; i < got; ++i)
        write(out, done + i, (float)((buf[i] - mean) * inv_std));
      done += (int64_t)got;
    }
  }
  fclose(f);
  return done == info.elems ? done : -1;
}

// Shared flat/ragged pack loop: file i writes at out + offsets_elems[i] with
// capacity offsets_elems[i+1] - offsets_elems[i]. Returns failed-file count.
template <typename Writer>
int64_t pack_var(const char** paths, int64_t n, typename Writer::Out* out,
                 const int64_t* offsets_elems, float mean, float inv_std,
                 int threads) {
  if (threads < 1) threads = 1;
  std::atomic<int64_t> next(0), failures(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      int64_t cap = offsets_elems[i + 1] - offsets_elems[i];
      if (load_one<Writer>(paths[i], out + offsets_elems[i], cap, mean,
                           inv_std) < 0)
        failures.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads - 1; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return failures.load();
}

// One file's element count (-1 when it does not open or is not a .npy the
// packer takes); on success sets *shape0 (segment count); sets *nbytes (if
// given) to the file's size from fstat of the open file, -1 if it does not
// open.
int64_t probe_file(const char* path, int64_t* shape0, int64_t* nbytes) {
  if (nbytes) *nbytes = -1;
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  struct stat st;
  if (nbytes && fstat(fileno(f), &st) == 0) *nbytes = (int64_t)st.st_size;
  NpyInfo info = parse_header(f);
  fclose(f);
  if (!info.ok) return -1;
  if (shape0) *shape0 = info.shape0;
  return info.elems;
}

}  // namespace

extern "C" {

// Probe n files on `threads` workers: elems[i] is file i's element count,
// or -1 when it is not a .npy the packer takes, shape0[i] its segment count
// and nbytes[i] its size in bytes (fstat of the open file; -1 when it does
// not open). One call for a whole split, which also gives the split's size
// on disk: at 306 000 files one ctypes call (or one stat) per file from
// Python costs tens of seconds on a slow file system. Returns the number
// of files whose elems is -1.
int64_t afsl_npy_probe_many(const char** paths, int64_t n, int64_t* elems,
                            int64_t* shape0, int64_t* nbytes, int threads) {
  if (threads < 1) threads = 1;
  std::atomic<int64_t> next(0), failures(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      shape0[i] = 1;
      elems[i] = probe_file(paths[i], &shape0[i], &nbytes[i]);
      if (elems[i] < 0) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads - 1; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return failures.load();
}

// Pack n files into `out` (preallocated, zero-initialized). File i writes at
// out + i*stride_elems, up to stride_elems elements, normalized
// (x - mean) * inv_std. Runs on `threads` workers. Returns the number of
// files that FAILED (0 == success).
int64_t afsl_pack_f32(const char** paths, int64_t n, float* out,
                      int64_t stride_elems, float mean, float inv_std,
                      int threads) {
  if (threads < 1) threads = 1;
  std::atomic<int64_t> next(0), failures(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      if (load_one<WriteF32>(paths[i], out + i * stride_elems, stride_elems,
                             mean, inv_std) < 0)
        failures.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads - 1; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return failures.load();
}

// Flat/ragged variant: file i writes at out + offsets_elems[i] with capacity
// offsets_elems[i+1] - offsets_elems[i] (offsets has n+1 entries). Used for
// the flat segment store where items carry different segment counts.
int64_t afsl_pack_f32_var(const char** paths, int64_t n, float* out,
                          const int64_t* offsets_elems, float mean,
                          float inv_std, int threads) {
  return pack_var<WriteF32>(paths, n, out, offsets_elems, mean, inv_std,
                            threads);
}

// bfloat16 flat/ragged variant (round to nearest even, as torch converts):
// tpu.store_dtype = 'bfloat16', half the store's bytes.
int64_t afsl_pack_bf16_var(const char** paths, int64_t n, uint16_t* out,
                           const int64_t* offsets_elems, float mean,
                           float inv_std, int threads) {
  return pack_var<WriteBF16>(paths, n, out, offsets_elems, mean, inv_std,
                             threads);
}

}  // extern "C"

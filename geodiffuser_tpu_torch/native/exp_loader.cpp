// Native experiment-folder loader and prefetcher of the PyTorch port.
//
// A copy of geodiffuser_tpu/native/exp_loader.cpp whose experiment decode
// also reads what the port's Python reader (utils/exp_io.py:read_exp) reads:
// the optional background_image.png, transformed_image.png and result.png,
// and image_shape.npy, with every .npy array handed over in its own dtype.
// It provides:
//   * a minimal NPY reader (v1/v2 headers, C-order, little-endian)
//   * a minimal PNG decoder (8-bit gray/RGB/RGBA, non-interlaced, zlib)
//   * a threaded prefetcher that decodes the next experiment folders in the
//     background while the device runs the current edit, and hands them
//     out in folder order (the JAX package's copy hands them out in the
//     order its threads finish).
//
// Exposed through a plain C ABI for ctypes.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC exp_loader.cpp -o libexploader.so -lz -lpthread

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- file IO
bool read_file(const std::string& path, std::vector<uint8_t>& out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out.resize(n);
  size_t got = fread(out.data(), 1, n, f);
  fclose(f);
  return got == static_cast<size_t>(n);
}

// ---------------------------------------------------------------- NPY
struct Array {
  std::vector<int64_t> shape;
  std::string dtype;       // "f4", "f8", "u1", "i4", "i8"
  std::string descr;       // as stored, e.g. "<f4", "|u1"
  std::vector<uint8_t> data;
};

bool parse_npy(const std::vector<uint8_t>& buf, Array& arr) {
  if (buf.size() < 10 || memcmp(buf.data(), "\x93NUMPY", 6) != 0) return false;
  int major = buf[6];
  size_t hlen, off;
  if (major == 1) {
    hlen = buf[8] | (buf[9] << 8);
    off = 10;
  } else {
    hlen = buf[8] | (buf[9] << 8) | (buf[10] << 16) | (static_cast<size_t>(buf[11]) << 24);
    off = 12;
  }
  std::string header(reinterpret_cast<const char*>(buf.data() + off), hlen);
  // descr
  size_t d = header.find("'descr'");
  if (d == std::string::npos) return false;
  size_t q1 = header.find('\'', d + 7);
  size_t q2 = header.find('\'', q1 + 1);
  std::string descr = header.substr(q1 + 1, q2 - q1 - 1);
  if (descr.size() < 2) return false;
  if (descr[0] == '>') return false;  // big-endian unsupported
  arr.descr = descr;
  arr.dtype = descr.substr(1);
  // fortran_order
  if (header.find("'fortran_order': True") != std::string::npos) return false;
  // shape
  size_t s = header.find("'shape':");
  size_t p1 = header.find('(', s);
  size_t p2 = header.find(')', p1);
  std::string shape_s = header.substr(p1 + 1, p2 - p1 - 1);
  arr.shape.clear();
  int64_t cur = -1;
  for (char c : shape_s) {
    if (c >= '0' && c <= '9') {
      cur = (cur < 0 ? 0 : cur) * 10 + (c - '0');
    } else if (cur >= 0) {
      arr.shape.push_back(cur);
      cur = -1;
    }
  }
  if (cur >= 0) arr.shape.push_back(cur);
  arr.data.assign(buf.begin() + off + hlen, buf.end());
  return true;
}

// ---------------------------------------------------------------- PNG
uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decode an 8-bit non-interlaced gray/RGB/RGBA PNG into RGB (3 channels).
bool decode_png(const std::vector<uint8_t>& buf, int64_t& h, int64_t& w,
                std::vector<uint8_t>& rgb) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', 0x0d, 0x0a, 0x1a, 0x0a};
  if (buf.size() < 8 || memcmp(buf.data(), sig, 8) != 0) return false;
  size_t pos = 8;
  uint32_t width = 0, height = 0;
  int bit_depth = 0, color_type = -1, interlace = 0;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> palette;
  while (pos + 8 <= buf.size()) {
    uint32_t len = be32(&buf[pos]);
    const char* type = reinterpret_cast<const char*>(&buf[pos + 4]);
    const uint8_t* data = &buf[pos + 8];
    if (memcmp(type, "IHDR", 4) == 0) {
      width = be32(data);
      height = be32(data + 4);
      bit_depth = data[8];
      color_type = data[9];
      interlace = data[12];
    } else if (memcmp(type, "PLTE", 4) == 0) {
      palette.assign(data, data + len);
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (bit_depth != 8 || interlace != 0) return false;
  int ch;
  switch (color_type) {
    case 0: ch = 1; break;  // gray
    case 2: ch = 3; break;  // rgb
    case 3: ch = 1; break;  // palette
    case 4: ch = 2; break;  // gray+alpha
    case 6: ch = 4; break;  // rgba
    default: return false;
  }
  size_t stride = size_t(width) * ch;
  std::vector<uint8_t> raw((stride + 1) * height);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK) return false;

  // un-filter
  std::vector<uint8_t> img(stride * height);
  for (uint32_t y = 0; y < height; ++y) {
    uint8_t filter = raw[y * (stride + 1)];
    const uint8_t* src = &raw[y * (stride + 1) + 1];
    uint8_t* dst = &img[y * stride];
    const uint8_t* up = y ? &img[(y - 1) * stride] : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= size_t(ch) ? dst[x - ch] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= size_t(ch)) ? up[x - ch] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return false;
      }
      dst[x] = uint8_t(v);
    }
  }

  h = height;
  w = width;
  rgb.resize(size_t(width) * height * 3);
  for (size_t i = 0; i < size_t(width) * height; ++i) {
    const uint8_t* px = &img[i * ch];
    uint8_t r, g, b;
    switch (color_type) {
      case 0: case 4: r = g = b = px[0]; break;
      case 3: {
        size_t pi = size_t(px[0]) * 3;
        if (pi + 2 >= palette.size()) return false;
        r = palette[pi]; g = palette[pi + 1]; b = palette[pi + 2];
        break;
      }
      default: r = px[0]; g = px[1]; b = px[2]; break;
    }
    rgb[i * 3] = r;
    rgb[i * 3 + 1] = g;
    rgb[i * 3 + 2] = b;
  }
  return true;
}

// ---------------------------------------------------------------- experiment
struct Image {
  bool present = false;
  int64_t h = 0, w = 0;
  std::vector<uint8_t> rgb;        // (h, w, 3)
};

// the PNGs of a folder: input image, mask (as stored, made RGB), then the
// optional ones
const char* const kImages[] = {"input_image.png", "input_mask.png", "background_image.png",
                               "transformed_image.png", "result.png"};
constexpr int kNumImages = 5;
constexpr int kRequiredImages = 2;
// the arrays: depth and transform, then the optional image shape
const char* const kArrays[] = {"depth.npy", "transform.npy", "image_shape.npy"};
constexpr int kNumArrays = 3;
constexpr int kRequiredArrays = 2;

struct Experiment {
  Image images[kNumImages];
  Array arrays[kNumArrays];
  bool array_present[kNumArrays] = {};
  bool ok = false;
  std::string path;
};

bool file_exists(const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fclose(f);
  return true;
}

// ok stays false when a required file is missing or any file present cannot
// be decoded here (the Python reader then takes the folder)
bool load_experiment(const std::string& folder, Experiment& e) {
  std::vector<uint8_t> buf;
  e.path = folder;
  for (int i = 0; i < kNumImages; ++i) {
    const std::string path = folder + "/" + kImages[i];
    if (i >= kRequiredImages && !file_exists(path)) continue;
    Image& im = e.images[i];
    if (!read_file(path, buf)) return false;
    if (!decode_png(buf, im.h, im.w, im.rgb)) return false;
    im.present = true;
  }
  for (int i = 0; i < kNumArrays; ++i) {
    const std::string path = folder + "/" + kArrays[i];
    if (i >= kRequiredArrays && !file_exists(path)) continue;
    if (!read_file(path, buf)) return false;
    if (!parse_npy(buf, e.arrays[i])) return false;
    e.array_present[i] = true;
  }
  e.ok = true;
  return true;
}

// Workers decode folders in index order as they take them, but finish in
// any order: each decoded experiment waits in `ready` under its index, and
// next() hands them out in folder order.  A worker holds a decoded
// experiment back while it is max_queue or more places ahead of the next
// one to be served, so the one the caller waits for is never blocked.
struct Prefetcher {
  std::vector<std::string> folders;
  std::map<size_t, Experiment*> ready;
  size_t next_served = 0;          // guarded by mu
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<size_t> next_idx{0};
  std::vector<std::thread> workers;
  size_t max_queue;
  std::atomic<bool> stop{false};

  Prefetcher(const std::vector<std::string>& fs, int n_threads, size_t max_q)
      : folders(fs), max_queue(max_q < 1 ? 1 : max_q) {
    for (int i = 0; i < n_threads; ++i) {
      workers.emplace_back([this] { run(); });
    }
  }

  void run() {
    while (!stop) {
      size_t idx = next_idx.fetch_add(1);
      if (idx >= folders.size()) return;
      auto* e = new Experiment();
      load_experiment(folders[idx], *e);
      std::unique_lock<std::mutex> lk(mu);
      cv.wait(lk, [&] { return idx < next_served + max_queue || stop; });
      if (stop) { delete e; return; }
      ready[idx] = e;
      cv.notify_all();
    }
  }

  // The experiment of folder `served` (the caller's count of experiments
  // taken so far), or nullptr past the last folder.
  Experiment* next(size_t served) {
    std::unique_lock<std::mutex> lk(mu);
    if (served >= folders.size()) return nullptr;
    cv.wait(lk, [&] { return ready.count(served) > 0; });
    Experiment* e = ready[served];
    ready.erase(served);
    next_served = served + 1;
    cv.notify_all();
    return e;
  }

  ~Prefetcher() {
    stop = true;
    cv.notify_all();
    for (auto& t : workers) t.join();
    for (auto& kv : ready) delete kv.second;
  }
};

}  // namespace

// ------------------------------------------------------------------- C ABI
extern "C" {

// NPY: returns 0 on success; caller passes out buffers.
int gd_load_npy(const char* path, double* out, int64_t max_elems,
                int64_t* shape_out, int* ndim_out) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return 1;
  Array a;
  if (!parse_npy(buf, a)) return 2;
  int64_t n = 1;
  for (size_t i = 0; i < a.shape.size(); ++i) {
    shape_out[i] = a.shape[i];
    n *= a.shape[i];
  }
  *ndim_out = int(a.shape.size());
  if (n > max_elems) return 3;
  if (a.dtype == "f4") {
    const float* p = reinterpret_cast<const float*>(a.data.data());
    for (int64_t i = 0; i < n; ++i) out[i] = p[i];
  } else if (a.dtype == "f8") {
    memcpy(out, a.data.data(), n * 8);
  } else if (a.dtype == "i8") {
    const int64_t* p = reinterpret_cast<const int64_t*>(a.data.data());
    for (int64_t i = 0; i < n; ++i) out[i] = double(p[i]);
  } else if (a.dtype == "i4") {
    const int32_t* p = reinterpret_cast<const int32_t*>(a.data.data());
    for (int64_t i = 0; i < n; ++i) out[i] = double(p[i]);
  } else if (a.dtype == "u1") {
    for (int64_t i = 0; i < n; ++i) out[i] = double(a.data[i]);
  } else {
    return 4;
  }
  return 0;
}

// PNG -> RGB uint8; returns 0 on success.
int gd_load_png(const char* path, uint8_t* out, int64_t max_bytes,
                int64_t* h_out, int64_t* w_out) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return 1;
  int64_t h, w;
  std::vector<uint8_t> rgb;
  if (!decode_png(buf, h, w, rgb)) return 2;
  if (int64_t(rgb.size()) > max_bytes) return 3;
  memcpy(out, rgb.data(), rgb.size());
  *h_out = h;
  *w_out = w;
  return 0;
}

void* gd_prefetcher_create(const char** folders, int n, int threads, int max_queue) {
  std::vector<std::string> fs(folders, folders + n);
  return new Prefetcher(fs, threads, size_t(max_queue));
}

// Pops the next loaded experiment; returns an opaque handle or nullptr.
void* gd_prefetcher_next(void* p, int64_t served) {
  return static_cast<Prefetcher*>(p)->next(size_t(served));
}

int gd_exp_ok(void* e) { return static_cast<Experiment*>(e)->ok ? 1 : 0; }

const char* gd_exp_path(void* e) { return static_cast<Experiment*>(e)->path.c_str(); }

// Image `which` (kImages order) of an experiment: returns 1 and its size
// (copying its (h, w, 3) bytes when out is not null), or 0 when absent.
int gd_exp_image(void* ep, int which, uint8_t* out, int64_t* h, int64_t* w) {
  auto* e = static_cast<Experiment*>(ep);
  if (which < 0 || which >= kNumImages || !e->images[which].present) return 0;
  const Image& im = e->images[which];
  *h = im.h;
  *w = im.w;
  if (out) memcpy(out, im.rgb.data(), im.rgb.size());
  return 1;
}

// Array `which` (kArrays order): returns 1 with its shape, its numpy descr
// (at most 15 characters) and, when out is not null, its raw bytes (at most
// max_bytes); 0 when absent.
int gd_exp_array(void* ep, int which, uint8_t* out, int64_t max_bytes, int64_t* shape,
                 int* ndim, char* descr16, int64_t* nbytes) {
  auto* e = static_cast<Experiment*>(ep);
  if (which < 0 || which >= kNumArrays || !e->array_present[which]) return 0;
  const Array& a = e->arrays[which];
  *ndim = int(a.shape.size());
  for (size_t i = 0; i < a.shape.size() && i < 8; ++i) shape[i] = a.shape[i];
  snprintf(descr16, 16, "%s", a.descr.c_str());
  *nbytes = int64_t(a.data.size());
  if (out && *nbytes <= max_bytes) memcpy(out, a.data.data(), a.data.size());
  return 1;
}

void gd_exp_free(void* e) { delete static_cast<Experiment*>(e); }

void gd_prefetcher_destroy(void* p) { delete static_cast<Prefetcher*>(p); }

}  // extern "C"

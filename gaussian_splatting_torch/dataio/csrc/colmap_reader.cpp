// Native COLMAP sparse-reconstruction binary reader (the port's copy of
// native/colmap_reader.cpp, unchanged below this comment).
//
// Parses cameras.bin / images.bin / points3D.bin
// (https://colmap.github.io/format.html) in one pass into flat arrays behind
// a C ABI, read from Python through ctypes
// (gaussian_splatting_torch/dataio/native.py, which builds this file with
// g++ into the package's _build_cache/ at first use).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Buffer {
  std::vector<char> data;
  size_t pos = 0;

  bool load(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    data.resize(static_cast<size_t>(size));
    size_t got = size ? std::fread(data.data(), 1, data.size(), f) : 0;
    std::fclose(f);
    return got == data.size();
  }

  template <typename T>
  bool read(T* out, size_t count = 1) {
    size_t bytes = sizeof(T) * count;
    if (pos + bytes > data.size()) return false;
    std::memcpy(out, data.data() + pos, bytes);
    pos += bytes;
    return true;
  }

  bool read_string(std::string* out) {
    out->clear();
    while (pos < data.size()) {
      char c = data[pos++];
      if (c == '\0') return true;
      out->push_back(c);
    }
    return false;
  }

  bool skip(size_t bytes) {
    if (pos + bytes > data.size()) return false;
    pos += bytes;
    return true;
  }
};

int camera_model_num_params(int model_id) {
  switch (model_id) {
    case 0: return 3;   // SIMPLE_PINHOLE
    case 1: return 4;   // PINHOLE
    case 2: return 4;   // SIMPLE_RADIAL
    case 3: return 5;   // RADIAL
    case 4: return 8;   // OPENCV
    case 5: return 8;   // OPENCV_FISHEYE
    case 6: return 12;  // FULL_OPENCV
    case 7: return 5;   // FOV
    case 8: return 4;   // SIMPLE_RADIAL_FISHEYE
    case 9: return 5;   // RADIAL_FISHEYE
    case 10: return 12; // THIN_PRISM_FISHEYE
    default: return -1;
  }
}

struct Points {
  std::vector<double> xyz;       // (n, 3)
  std::vector<uint8_t> rgb;      // (n, 3)
  std::vector<double> error;     // (n,)
  std::vector<int64_t> ids;      // (n,)
};

struct Images {
  std::vector<int32_t> image_ids;   // (n,)
  std::vector<double> qvec;         // (n, 4) wxyz
  std::vector<double> tvec;         // (n, 3)
  std::vector<int32_t> camera_ids;  // (n,)
  std::vector<char> names;          // (n, 256) zero-padded
};

struct Cameras {
  std::vector<int32_t> camera_ids;  // (n,)
  std::vector<int32_t> model_ids;   // (n,)
  std::vector<int64_t> wh;          // (n, 2)
  std::vector<double> params;       // (n, 12) zero-padded
};

}  // namespace

extern "C" {

// ---- points3D.bin ---------------------------------------------------------

void* colmap_points_read(const char* path) {
  Buffer buf;
  if (!buf.load(path)) return nullptr;
  uint64_t n = 0;
  if (!buf.read(&n)) return nullptr;
  auto* p = new Points();
  p->xyz.resize(n * 3);
  p->rgb.resize(n * 3);
  p->error.resize(n);
  p->ids.resize(n);
  for (uint64_t i = 0; i < n; ++i) {
    int64_t pid;
    uint64_t track_len;
    if (!buf.read(&pid) || !buf.read(&p->xyz[i * 3], 3) ||
        !buf.read(&p->rgb[i * 3], 3) || !buf.read(&p->error[i]) ||
        !buf.read(&track_len) ||
        !buf.skip(track_len * (sizeof(int32_t) * 2))) {
      delete p;
      return nullptr;
    }
    p->ids[i] = pid;
  }
  return p;
}

int64_t colmap_points_count(void* h) {
  return static_cast<int64_t>(static_cast<Points*>(h)->ids.size());
}

void colmap_points_fill(void* h, double* xyz, uint8_t* rgb, double* error,
                        int64_t* ids) {
  auto* p = static_cast<Points*>(h);
  std::memcpy(xyz, p->xyz.data(), p->xyz.size() * sizeof(double));
  std::memcpy(rgb, p->rgb.data(), p->rgb.size());
  std::memcpy(error, p->error.data(), p->error.size() * sizeof(double));
  std::memcpy(ids, p->ids.data(), p->ids.size() * sizeof(int64_t));
}

void colmap_points_free(void* h) { delete static_cast<Points*>(h); }

// ---- images.bin -----------------------------------------------------------

void* colmap_images_read(const char* path) {
  Buffer buf;
  if (!buf.load(path)) return nullptr;
  uint64_t n = 0;
  if (!buf.read(&n)) return nullptr;
  auto* im = new Images();
  im->image_ids.resize(n);
  im->qvec.resize(n * 4);
  im->tvec.resize(n * 3);
  im->camera_ids.resize(n);
  im->names.assign(n * 256, '\0');
  for (uint64_t i = 0; i < n; ++i) {
    std::string name;
    uint64_t n_pts2d;
    if (!buf.read(&im->image_ids[i]) || !buf.read(&im->qvec[i * 4], 4) ||
        !buf.read(&im->tvec[i * 3], 3) || !buf.read(&im->camera_ids[i]) ||
        !buf.read_string(&name) || !buf.read(&n_pts2d) ||
        !buf.skip(n_pts2d * (sizeof(double) * 2 + sizeof(int64_t)))) {
      delete im;
      return nullptr;
    }
    std::strncpy(&im->names[i * 256], name.c_str(), 255);
  }
  return im;
}

int64_t colmap_images_count(void* h) {
  return static_cast<int64_t>(static_cast<Images*>(h)->image_ids.size());
}

void colmap_images_fill(void* h, int32_t* image_ids, double* qvec,
                        double* tvec, int32_t* camera_ids, char* names) {
  auto* im = static_cast<Images*>(h);
  size_t n = im->image_ids.size();
  std::memcpy(image_ids, im->image_ids.data(), n * sizeof(int32_t));
  std::memcpy(qvec, im->qvec.data(), n * 4 * sizeof(double));
  std::memcpy(tvec, im->tvec.data(), n * 3 * sizeof(double));
  std::memcpy(camera_ids, im->camera_ids.data(), n * sizeof(int32_t));
  std::memcpy(names, im->names.data(), n * 256);
}

void colmap_images_free(void* h) { delete static_cast<Images*>(h); }

// ---- cameras.bin ----------------------------------------------------------

void* colmap_cameras_read(const char* path) {
  Buffer buf;
  if (!buf.load(path)) return nullptr;
  uint64_t n = 0;
  if (!buf.read(&n)) return nullptr;
  auto* c = new Cameras();
  c->camera_ids.resize(n);
  c->model_ids.resize(n);
  c->wh.resize(n * 2);
  c->params.assign(n * 12, 0.0);
  for (uint64_t i = 0; i < n; ++i) {
    if (!buf.read(&c->camera_ids[i]) || !buf.read(&c->model_ids[i]) ||
        !buf.read(&c->wh[i * 2], 2)) {
      delete c;
      return nullptr;
    }
    int np = camera_model_num_params(c->model_ids[i]);
    if (np < 0 || !buf.read(&c->params[i * 12], np)) {
      delete c;
      return nullptr;
    }
  }
  return c;
}

int64_t colmap_cameras_count(void* h) {
  return static_cast<int64_t>(static_cast<Cameras*>(h)->camera_ids.size());
}

void colmap_cameras_fill(void* h, int32_t* camera_ids, int32_t* model_ids,
                         int64_t* wh, double* params) {
  auto* c = static_cast<Cameras*>(h);
  size_t n = c->camera_ids.size();
  std::memcpy(camera_ids, c->camera_ids.data(), n * sizeof(int32_t));
  std::memcpy(model_ids, c->model_ids.data(), n * sizeof(int32_t));
  std::memcpy(wh, c->wh.data(), n * 2 * sizeof(int64_t));
  std::memcpy(params, c->params.data(), n * 12 * sizeof(double));
}

void colmap_cameras_free(void* h) { delete static_cast<Cameras*>(h); }

}  // extern "C"

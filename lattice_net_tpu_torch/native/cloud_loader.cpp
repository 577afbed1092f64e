// cloud_loader: threaded point-cloud prefetcher with a bounded ring buffer.
//
// The PyTorch port's copy of native/cloud_loader.cpp (the same code), which
// stands in for the reference's external C++ `dataloaders` library
// (DataLoaderShapeNetPartSeg / DataLoaderSemanticKitti / ... — worker
// threads decoding files while the device computes; see SURVEY.md L7/Lz).
// N reader threads parse scans (KITTI .bin + .label, ShapeNet .pts + .seg)
// into contiguous float/int buffers; python drains them through a ctypes C
// API without holding the GIL during IO/parse.
//
// C API (stable, ctypes-friendly):
//   void*  loader_create(const char** paths, const char** label_paths,
//                        int n_files, int format, int n_threads,
//                        int queue_capacity, int shuffle, unsigned seed,
//                        int loop);
//   int    loader_next(void* h, float** xyz, float** extra, int** labels,
//                      int* n_points);   // 1 ok, 0 end-of-data, blocks
//   void   loader_free_sample(float* xyz, float* extra, int* labels);
//   void   loader_destroy(void* h);
//   int    loader_queue_depth(void* h);
//
// format: 0 = KITTI velodyne .bin (xyz+intensity, uint32 .label files)
//         1 = ShapeNet .pts text (xyz, int .seg labels)

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Sample {
  float* xyz = nullptr;    // n*3
  float* extra = nullptr;  // n*1 (intensity) or nullptr-equivalent zeros
  int* labels = nullptr;   // n
  int n = 0;
};

struct Loader {
  std::vector<std::string> files;
  std::vector<std::string> label_files;
  int format = 0;
  int queue_capacity = 8;
  bool loop = false;

  std::deque<Sample> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::atomic<size_t> next_file{0};  // monotonic; never wraps
  std::atomic<bool> stop{false};
  std::atomic<int> active_workers{0};
  std::vector<std::thread> workers;

  // per-epoch shuffle state (loop mode), guarded by perm_mu.  The permutation
  // for epoch e is a deterministic function of (seed, e), so two workers
  // regenerating it concurrently produce the same result (idempotent).
  std::mutex perm_mu;
  std::vector<size_t> perm;
  size_t perm_epoch = SIZE_MAX;
  bool reshuffle = false;
  unsigned perm_seed = 0;

  size_t file_index_for(size_t ticket) {
    size_t n = files.size();
    size_t epoch = ticket / n, pos = ticket % n;
    if (!reshuffle) return pos;
    std::lock_guard<std::mutex> lk(perm_mu);
    if (perm_epoch != epoch) {
      perm.resize(n);
      for (size_t i = 0; i < n; i++) perm[i] = i;
      std::mt19937 rng(perm_seed + 0x9e3779b9u * static_cast<unsigned>(epoch));
      std::shuffle(perm.begin(), perm.end(), rng);
      perm_epoch = epoch;
    }
    return perm[pos];
  }
};

bool read_kitti_bin(const std::string& path, const std::string& label_path,
                    Sample* s) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  int n = static_cast<int>(bytes / (4 * sizeof(float)));
  std::vector<float> raw(static_cast<size_t>(n) * 4);
  size_t got = std::fread(raw.data(), sizeof(float), raw.size(), f);
  std::fclose(f);
  if (got != raw.size()) return false;

  s->n = n;
  s->xyz = static_cast<float*>(std::malloc(sizeof(float) * n * 3));
  s->extra = static_cast<float*>(std::malloc(sizeof(float) * n));
  s->labels = static_cast<int*>(std::malloc(sizeof(int) * n));
  for (int i = 0; i < n; i++) {
    s->xyz[i * 3 + 0] = raw[i * 4 + 0];
    s->xyz[i * 3 + 1] = raw[i * 4 + 1];
    s->xyz[i * 3 + 2] = raw[i * 4 + 2];
    s->extra[i] = raw[i * 4 + 3];
  }
  std::memset(s->labels, 0, sizeof(int) * n);
  if (!label_path.empty()) {
    FILE* lf = std::fopen(label_path.c_str(), "rb");
    if (lf) {
      std::vector<uint32_t> lab(n);
      size_t lgot = std::fread(lab.data(), sizeof(uint32_t), n, lf);
      std::fclose(lf);
      for (size_t i = 0; i < lgot; i++)
        s->labels[i] = static_cast<int>(lab[i] & 0xFFFFu);  // semantic id
    }
  }
  return true;
}

bool read_shapenet_pts(const std::string& path, const std::string& label_path,
                       Sample* s) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  std::vector<float> pts;
  pts.reserve(3 * 4096);
  float x, y, z;
  while (std::fscanf(f, "%f %f %f", &x, &y, &z) == 3) {
    pts.push_back(x);
    pts.push_back(y);
    pts.push_back(z);
  }
  std::fclose(f);
  int n = static_cast<int>(pts.size() / 3);
  if (n == 0) return false;
  s->n = n;
  s->xyz = static_cast<float*>(std::malloc(sizeof(float) * n * 3));
  std::memcpy(s->xyz, pts.data(), sizeof(float) * n * 3);
  s->extra = static_cast<float*>(std::calloc(n, sizeof(float)));
  s->labels = static_cast<int*>(std::calloc(n, sizeof(int)));
  if (!label_path.empty()) {
    FILE* lf = std::fopen(label_path.c_str(), "rb");
    if (lf) {
      int v, i = 0;
      while (i < n && std::fscanf(lf, "%d", &v) == 1) s->labels[i++] = v;
      std::fclose(lf);
    }
  }
  return true;
}

void worker_main(Loader* L, unsigned seed) {
  std::mt19937 rng(seed);
  // active_workers was pre-counted in loader_create (before threads spawn)
  // so a consumer arriving early cannot observe 0 workers + empty queue.
  for (;;) {
    // ticket counter is monotonic: no wrap race, every scan is visited exactly
    // once per epoch; loop mode maps tickets through a per-epoch permutation.
    size_t ticket = L->next_file.fetch_add(1);
    if (!L->loop && ticket >= L->files.size()) break;
    size_t idx = L->file_index_for(ticket);
    if (L->stop.load()) break;

    Sample s;
    const std::string& lp =
        L->label_files.empty() ? std::string() : L->label_files[idx];
    bool ok = (L->format == 0) ? read_kitti_bin(L->files[idx], lp, &s)
                               : read_shapenet_pts(L->files[idx], lp, &s);
    if (!ok) continue;

    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_push.wait(lk, [&] {
      return L->stop.load() || (int)L->queue.size() < L->queue_capacity;
    });
    if (L->stop.load()) {
      std::free(s.xyz);
      std::free(s.extra);
      std::free(s.labels);
      break;
    }
    L->queue.push_back(s);
    L->cv_pop.notify_one();
  }
  {
    // hold the mutex so a consumer mid-predicate cannot miss the final wake
    // (lost-wakeup between its check of active_workers and its cv wait).
    std::lock_guard<std::mutex> lk(L->mu);
    L->active_workers.fetch_sub(1);
  }
  L->cv_pop.notify_all();
}

}  // namespace

extern "C" {

void* loader_create(const char** paths, const char** label_paths, int n_files,
                    int format, int n_threads, int queue_capacity, int shuffle,
                    unsigned seed, int loop) {
  auto* L = new Loader();
  L->format = format;
  L->queue_capacity = queue_capacity > 0 ? queue_capacity : 8;
  L->loop = loop != 0;
  L->files.reserve(n_files);
  for (int i = 0; i < n_files; i++) L->files.emplace_back(paths[i]);
  if (label_paths) {
    L->label_files.reserve(n_files);
    for (int i = 0; i < n_files; i++)
      L->label_files.emplace_back(label_paths[i] ? label_paths[i] : "");
  }
  if (shuffle && L->loop) {
    // loop mode: fresh permutation each epoch (epoch 0 included) instead of a
    // single create-time shuffle repeated forever.
    L->reshuffle = true;
    L->perm_seed = seed;
  } else if (shuffle) {
    std::mt19937 rng(seed);
    std::vector<size_t> perm(L->files.size());
    for (size_t i = 0; i < perm.size(); i++) perm[i] = i;
    std::shuffle(perm.begin(), perm.end(), rng);
    std::vector<std::string> f2(L->files.size()), l2(L->files.size());
    for (size_t i = 0; i < perm.size(); i++) {
      f2[i] = L->files[perm[i]];
      if (!L->label_files.empty()) l2[i] = L->label_files[perm[i]];
    }
    L->files.swap(f2);
    if (!L->label_files.empty()) L->label_files.swap(l2);
  }
  int nt = n_threads > 0 ? n_threads : 2;
  L->active_workers.store(nt);
  for (int t = 0; t < nt; t++)
    L->workers.emplace_back(worker_main, L, seed + 17 * t + 1);
  return L;
}

int loader_next(void* h, float** xyz, float** extra, int** labels,
                int* n_points) {
  auto* L = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_pop.wait(lk, [&] {
    return !L->queue.empty() || L->active_workers.load() == 0 || L->stop.load();
  });
  if (L->queue.empty()) return 0;
  Sample s = L->queue.front();
  L->queue.pop_front();
  L->cv_push.notify_one();
  *xyz = s.xyz;
  *extra = s.extra;
  *labels = s.labels;
  *n_points = s.n;
  return 1;
}

void loader_free_sample(float* xyz, float* extra, int* labels) {
  std::free(xyz);
  std::free(extra);
  std::free(labels);
}

int loader_queue_depth(void* h) {
  auto* L = static_cast<Loader*>(h);
  std::lock_guard<std::mutex> lk(L->mu);
  return static_cast<int>(L->queue.size());
}

void loader_destroy(void* h) {
  auto* L = static_cast<Loader*>(h);
  {
    // set stop under the mutex so threads blocked in (or entering) a cv wait
    // observe it and cannot sleep through the notify below.
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop.store(true);
  }
  L->cv_push.notify_all();
  L->cv_pop.notify_all();
  for (auto& t : L->workers) t.join();
  for (auto& s : L->queue) {
    std::free(s.xyz);
    std::free(s.extra);
    std::free(s.labels);
  }
  delete L;
}

}  // extern "C"

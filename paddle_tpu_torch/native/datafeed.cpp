// Native data-feed engine — multi-threaded slot-format ingestion,
// in-memory shuffle, batch packing with LoD offsets.
//
// TPU-native rebuild of the reference's C++ dataset stack (reference:
// paddle/fluid/framework/data_feed.h:106 MultiSlotDataFeed parsing,
// data_set.h:159 DatasetImpl in-memory shuffle, channel.h blocking
// channels, data_feed.cc slot-format grammar). The host side stays native
// C++ exactly like the reference's: N parser threads stream text files
// into pinned record storage, the trainer thread drains packed batches
// (contiguous value buffer + LoD offsets per slot) that Python hands to
// the jitted TPU step as device feeds.
//
// Slot-format line grammar (reference data_feed.cc CheckFile):
//   line := (slot_field)*           one group per registered slot, in order
//   slot_field := <n> <v1> ... <vn>
// float slots parse with strtof, id (uint64) slots with strtoll.
//
// C ABI (consumed via ctypes from ../fluid/dataset.py):
//   df_create(slot_spec) -> handle        spec: "name:f|i:dim,..."
//   df_set_filelist / df_set_batch / df_set_threads
//   df_load_into_memory(h)                parse all files (threaded)
//   df_local_shuffle(h, seed)
//   df_epoch_begin(h)                     reset batch cursor
//   df_next_batch(h) -> n_instances (0 = epoch end)
//   df_slot_total(h, s) -> values in current batch for slot s
//   df_slot_copy(h, s, values_out, lod_out)  fills value+offset buffers
//   df_memory_size(h) / df_release(h)
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <mutex>
#include <random>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Slot {
  std::string name;
  bool is_float;
  int dim;
};

// One parsed instance: per-slot ragged values (reference
// data_feed.h MultiSlotType).
struct Record {
  std::vector<std::vector<float>> fvals;
  std::vector<std::vector<int64_t>> ivals;
};

class DataFeed {
 public:
  explicit DataFeed(const std::string& spec) {
    std::stringstream ss(spec);
    std::string item;
    while (std::getline(ss, item, ',')) {
      if (item.empty()) continue;
      size_t a = item.find(':');
      size_t b = item.find(':', a + 1);
      Slot s;
      s.name = item.substr(0, a);
      s.is_float = item.substr(a + 1, b - a - 1) == "f";
      s.dim = std::atoi(item.c_str() + b + 1);
      slots_.push_back(s);
    }
  }

  void SetFileList(const char** files, int n) {
    files_.assign(files, files + n);
  }
  void SetBatch(int b) { batch_ = b; }
  void SetThreads(int t) { threads_ = t < 1 ? 1 : t; }

  // reference data_set.cc LoadIntoMemory: one thread per file shard.
  void LoadIntoMemory() {
    records_.clear();
    std::vector<std::thread> ths;
    std::vector<std::vector<Record>> parts(threads_);
    std::atomic<size_t> next_file{0};
    for (int t = 0; t < threads_; ++t) {
      ths.emplace_back([this, t, &parts, &next_file]() {
        for (;;) {
          size_t i = next_file.fetch_add(1);
          if (i >= files_.size()) return;
          ParseFile(files_[i], &parts[t]);
        }
      });
    }
    for (auto& th : ths) th.join();
    size_t total = 0;
    for (auto& p : parts) total += p.size();
    records_.reserve(total);
    for (auto& p : parts)
      for (auto& r : p) records_.push_back(std::move(r));
    cursor_ = 0;
  }

  void LocalShuffle(uint64_t seed) {
    std::mt19937_64 rng(seed);
    std::shuffle(records_.begin(), records_.end(), rng);
  }

  void EpochBegin() { cursor_ = 0; }

  // Packs the next batch; returns #instances (0 at epoch end).
  int NextBatch() {
    size_t n = std::min<size_t>(batch_, records_.size() - cursor_);
    cur_batch_.assign(records_.begin() + cursor_,
                      records_.begin() + cursor_ + n);
    cursor_ += n;
    return static_cast<int>(n);
  }

  int64_t SlotTotal(int s) const {
    int64_t total = 0;
    for (const auto& r : cur_batch_)
      total += slots_[s].is_float ? r.fvals[FloatIdx(s)].size()
                                  : r.ivals[IntIdx(s)].size();
    return total;
  }

  // values_out: float* or int64*; lod_out: int64[n_instances + 1] offsets.
  void SlotCopy(int s, void* values_out, int64_t* lod_out) const {
    int64_t off = 0;
    lod_out[0] = 0;
    for (size_t i = 0; i < cur_batch_.size(); ++i) {
      const Record& r = cur_batch_[i];
      if (slots_[s].is_float) {
        const auto& v = r.fvals[FloatIdx(s)];
        std::memcpy(static_cast<float*>(values_out) + off, v.data(),
                    v.size() * sizeof(float));
        off += v.size();
      } else {
        const auto& v = r.ivals[IntIdx(s)];
        std::memcpy(static_cast<int64_t*>(values_out) + off, v.data(),
                    v.size() * sizeof(int64_t));
        off += v.size();
      }
      lod_out[i + 1] = off;
    }
  }

  int64_t MemorySize() const { return static_cast<int64_t>(records_.size()); }
  int NumSlots() const { return static_cast<int>(slots_.size()); }

 private:
  int FloatIdx(int s) const {
    int k = 0;
    for (int i = 0; i < s; ++i)
      if (slots_[i].is_float) ++k;
    return k;
  }
  int IntIdx(int s) const {
    int k = 0;
    for (int i = 0; i < s; ++i)
      if (!slots_[i].is_float) ++k;
    return k;
  }

  void ParseFile(const std::string& path, std::vector<Record>* out) {
    std::ifstream in(path);
    std::string line;
    while (std::getline(in, line)) {
      const char* p = line.c_str();
      char* end = nullptr;
      Record rec;
      bool ok = true;
      for (const Slot& s : slots_) {
        long n = std::strtol(p, &end, 10);
        if (end == p || n < 0) { ok = false; break; }
        p = end;
        if (s.is_float) {
          std::vector<float> v;
          v.reserve(n);
          for (long i = 0; i < n; ++i) {
            v.push_back(std::strtof(p, &end));
            if (end == p) { ok = false; break; }
            p = end;
          }
          if (!ok) break;
          rec.fvals.push_back(std::move(v));
        } else {
          std::vector<int64_t> v;
          v.reserve(n);
          for (long i = 0; i < n; ++i) {
            v.push_back(std::strtoll(p, &end, 10));
            if (end == p) { ok = false; break; }
            p = end;
          }
          if (!ok) break;
          rec.ivals.push_back(std::move(v));
        }
      }
      if (ok) out->push_back(std::move(rec));
    }
  }

  std::vector<Slot> slots_;
  std::vector<std::string> files_;
  std::vector<Record> records_;
  std::vector<Record> cur_batch_;
  size_t cursor_ = 0;
  int batch_ = 1;
  int threads_ = 1;
};

}  // namespace

extern "C" {

void* df_create(const char* slot_spec) { return new DataFeed(slot_spec); }

void df_set_filelist(void* h, const char** files, int n) {
  static_cast<DataFeed*>(h)->SetFileList(files, n);
}
void df_set_batch(void* h, int b) { static_cast<DataFeed*>(h)->SetBatch(b); }
void df_set_threads(void* h, int t) {
  static_cast<DataFeed*>(h)->SetThreads(t);
}
void df_load_into_memory(void* h) {
  static_cast<DataFeed*>(h)->LoadIntoMemory();
}
void df_local_shuffle(void* h, uint64_t seed) {
  static_cast<DataFeed*>(h)->LocalShuffle(seed);
}
void df_epoch_begin(void* h) { static_cast<DataFeed*>(h)->EpochBegin(); }
int df_next_batch(void* h) { return static_cast<DataFeed*>(h)->NextBatch(); }
int64_t df_slot_total(void* h, int s) {
  return static_cast<DataFeed*>(h)->SlotTotal(s);
}
void df_slot_copy(void* h, int s, void* values, int64_t* lod) {
  static_cast<DataFeed*>(h)->SlotCopy(s, values, lod);
}
int64_t df_memory_size(void* h) {
  return static_cast<DataFeed*>(h)->MemorySize();
}
void df_release(void* h) { delete static_cast<DataFeed*>(h); }

}  // extern "C"

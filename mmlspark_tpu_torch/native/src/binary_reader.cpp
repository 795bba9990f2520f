// Native host-side data loader: whole-file (path, bytes) records with a
// prefetching thread pool and zip-archive inspection.
//
// TPU-native counterpart of the reference's record-reader C++/JVM stack
// (BinaryFileFormat.scala:114 / BinaryRecordReader.scala:34, whose heavy
// lifting happens in Hadoop's native IO): the TPU framework keeps the
// device fed from the host, so file scanning, reading, zip expansion and
// subsampling run in native threads off the Python GIL. Exposed as a
// plain C API consumed over ctypes (loader.py).
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -pthread binary_reader.cpp -lz
//
// Determinism: records are delivered in sorted-path file order regardless
// of thread scheduling (per-file results are re-sequenced), and sampling
// uses a per-file RNG seeded with (seed, file index).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <filesystem>
#include <fstream>
#include <map>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <fnmatch.h>
#include <zlib.h>

namespace fs = std::filesystem;

namespace {

struct Record {
  std::string path;
  std::vector<uint8_t> data;
};

struct FileResult {
  std::vector<Record> records;
  std::string error;  // empty on success
};

// ---------------------------------------------------------------------------
// zip central-directory parsing (no external zip lib; deflate via zlib)
// ---------------------------------------------------------------------------

uint16_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t rd32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

bool inflate_raw(const uint8_t* src, size_t src_len, std::vector<uint8_t>* out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -MAX_WBITS) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = static_cast<uInt>(src_len);
  zs.next_out = out->data();
  zs.avail_out = static_cast<uInt>(out->size());
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END && zs.total_out == out->size();
}

// Expands `blob` (a zip archive) into records named "<zip_path>/<member>".
bool expand_zip(const std::string& zip_path, const std::vector<uint8_t>& blob,
                std::vector<Record>* out, std::string* err) {
  if (blob.size() < 22) { *err = "zip too small"; return false; }
  // find End Of Central Directory (scan back over a possible comment)
  size_t eocd = std::string::npos;
  size_t lo = blob.size() >= 22 + 65535 ? blob.size() - 22 - 65535 : 0;
  for (size_t i = blob.size() - 22 + 1; i-- > lo;) {
    if (rd32(&blob[i]) == 0x06054b50) { eocd = i; break; }
  }
  if (eocd == std::string::npos) { *err = "zip: no EOCD"; return false; }
  uint16_t n_entries = rd16(&blob[eocd + 10]);
  uint32_t cd_off = rd32(&blob[eocd + 16]);
  // zip64: a sentinel field alone is not proof (a legal zip32 archive can
  // hold exactly 65535 members) — the discriminator is the zip64 EOCD
  // locator record (sig 0x07064b50, 20 bytes) directly before the EOCD
  bool has_z64_locator =
      eocd >= 20 && rd32(&blob[eocd - 20]) == 0x07064b50u;
  if (has_z64_locator &&
      (n_entries == 0xFFFFu || cd_off == 0xFFFFFFFFu)) {
    *err = "zip64 archives are not supported";
    return false;
  }

  size_t p = cd_off;
  for (uint16_t e = 0; e < n_entries; ++e) {
    if (p + 46 > blob.size() || rd32(&blob[p]) != 0x02014b50) {
      *err = "zip: bad central directory entry";
      return false;
    }
    uint16_t method = rd16(&blob[p + 10]);
    uint32_t csize = rd32(&blob[p + 20]);
    uint32_t usize = rd32(&blob[p + 24]);
    if (csize == 0xFFFFFFFFu || usize == 0xFFFFFFFFu) {
      *err = "zip64 archives are not supported";
      return false;
    }
    uint16_t name_len = rd16(&blob[p + 28]);
    uint16_t extra_len = rd16(&blob[p + 30]);
    uint16_t comment_len = rd16(&blob[p + 32]);
    uint32_t lho = rd32(&blob[p + 42]);
    std::string name(reinterpret_cast<const char*>(&blob[p + 46]), name_len);
    p += 46 + name_len + extra_len + comment_len;
    if (!name.empty() && name.back() == '/') continue;  // directory entry
    // local header gives the actual data offset
    if (lho + 30 > blob.size() || rd32(&blob[lho]) != 0x04034b50) {
      *err = "zip: bad local header";
      return false;
    }
    size_t data_off = lho + 30 + rd16(&blob[lho + 26]) + rd16(&blob[lho + 28]);
    if (data_off + csize > blob.size()) { *err = "zip: truncated"; return false; }
    Record rec;
    rec.path = zip_path + "/" + name;
    if (method == 0) {  // stored
      rec.data.assign(blob.begin() + data_off, blob.begin() + data_off + csize);
    } else if (method == 8) {  // deflate
      rec.data.resize(usize);
      // empty members: zlib rejects a null next_out, and there is
      // nothing to inflate anyway
      if (usize > 0 && !inflate_raw(&blob[data_off], csize, &rec.data)) {
        *err = "zip: inflate failed for " + name;
        return false;
      }
    } else {
      *err = "zip: unsupported method for " + name;
      return false;
    }
    out->push_back(std::move(rec));
  }
  return true;
}

// ---------------------------------------------------------------------------
// Reader: scan + thread-pool prefetch with in-order delivery
// ---------------------------------------------------------------------------

bool ends_with_nocase(const std::string& s, const std::string& suf) {
  if (s.size() < suf.size()) return false;
  for (size_t i = 0; i < suf.size(); ++i) {
    if (std::tolower(s[s.size() - suf.size() + i]) != suf[i]) return false;
  }
  return true;
}

class Reader {
 public:
  Reader(std::string root, bool recursive, std::string pattern,
         double sample_ratio, uint64_t seed, bool inspect_zip, int n_threads,
         int max_outstanding)
      : sample_ratio_(sample_ratio),
        seed_(seed),
        inspect_zip_(inspect_zip),
        max_outstanding_(std::max(max_outstanding, 1)) {
    scan(root, recursive, pattern);
    n_threads = std::max(1, std::min<int>(n_threads, 64));
    for (int i = 0; i < n_threads; ++i) {
      workers_.emplace_back([this] { work(); });
    }
  }

  ~Reader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_work_.notify_all();
    cv_done_.notify_all();
    for (auto& t : workers_) t.join();
  }

  // 1 = record delivered, 0 = end of stream, -1 = error (see last_error)
  int next(const char** path, const void** data, int64_t* size) {
    while (true) {
      if (rec_idx_ < current_.records.size()) {
        const Record& r = current_.records[rec_idx_++];
        *path = r.path.c_str();
        *data = r.data.data();
        *size = static_cast<int64_t>(r.data.size());
        return 1;
      }
      // current file exhausted: fetch the next file's results in order
      std::unique_lock<std::mutex> lk(mu_);
      if (next_to_deliver_ >= files_.size()) return 0;
      cv_done_.wait(lk, [this] {
        return stop_ || done_.count(next_to_deliver_) > 0;
      });
      if (stop_) return 0;
      current_ = std::move(done_[next_to_deliver_]);
      done_.erase(next_to_deliver_);
      ++next_to_deliver_;
      rec_idx_ = 0;
      cv_work_.notify_all();  // an outstanding slot freed
      if (!current_.error.empty()) {
        last_error_ = files_[next_to_deliver_ - 1] + ": " + current_.error;
        return -1;
      }
    }
  }

  const char* last_error() const { return last_error_.c_str(); }
  int64_t n_files() const { return static_cast<int64_t>(files_.size()); }

 private:
  void scan(const std::string& root, bool recursive,
            const std::string& pattern) {
    std::error_code ec;
    if (fs::is_regular_file(root, ec)) {
      files_.push_back(root);
      return;
    }
    auto match = [&](const fs::path& p) {
      return pattern.empty() ||
             fnmatch(pattern.c_str(), p.filename().c_str(), 0) == 0;
    };
    if (recursive) {
      for (fs::recursive_directory_iterator it(root, ec), end; it != end;
           it.increment(ec)) {
        if (!ec && it->is_regular_file(ec) && match(it->path())) {
          files_.push_back(it->path().string());
        }
      }
    } else {
      for (fs::directory_iterator it(root, ec), end; it != end;
           it.increment(ec)) {
        if (!ec && it->is_regular_file(ec) && match(it->path())) {
          files_.push_back(it->path().string());
        }
      }
    }
    std::sort(files_.begin(), files_.end());
  }

  void work() {
    while (true) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_work_.wait(lk, [this] {
          return stop_ || (next_to_read_ < files_.size() &&
                           next_to_read_ - next_to_deliver_ <
                               static_cast<size_t>(max_outstanding_));
        });
        if (stop_) return;
        idx = next_to_read_++;
      }
      // any escape (bad_alloc on a huge file, filesystem surprise) must
      // surface as a record error, not std::terminate the host process
      FileResult res;
      try {
        res = read_one(idx);
      } catch (const std::exception& e) {
        res.records.clear();
        res.error = std::string("native reader exception: ") + e.what();
      } catch (...) {
        res.records.clear();
        res.error = "native reader exception";
      }
      {
        std::lock_guard<std::mutex> lk(mu_);
        done_[idx] = std::move(res);
      }
      cv_done_.notify_all();
    }
  }

  FileResult read_one(size_t idx) {
    FileResult res;
    const std::string& fp = files_[idx];
    std::ifstream f(fp, std::ios::binary | std::ios::ate);
    if (!f) {
      res.error = "cannot open";
      return res;
    }
    auto size = f.tellg();
    f.seekg(0);
    std::vector<uint8_t> blob(static_cast<size_t>(size));
    if (size > 0 && !f.read(reinterpret_cast<char*>(blob.data()), size)) {
      res.error = "short read";
      return res;
    }
    std::vector<Record> recs;
    if (inspect_zip_ && ends_with_nocase(fp, ".zip")) {
      std::string err;
      if (!expand_zip(fp, blob, &recs, &err)) {
        res.error = err;
        return res;
      }
    } else {
      recs.push_back(Record{fp, std::move(blob)});
    }
    if (sample_ratio_ < 1.0) {
      std::mt19937_64 rng(seed_ * 0x9e3779b97f4a7c15ULL + idx);
      std::uniform_real_distribution<double> uni(0.0, 1.0);
      std::vector<Record> kept;
      for (auto& r : recs) {
        if (uni(rng) < sample_ratio_) kept.push_back(std::move(r));
      }
      recs = std::move(kept);
    }
    res.records = std::move(recs);
    return res;
  }

  std::vector<std::string> files_;
  double sample_ratio_;
  uint64_t seed_;
  bool inspect_zip_;
  int max_outstanding_;

  std::mutex mu_;
  std::condition_variable cv_work_, cv_done_;
  std::vector<std::thread> workers_;
  std::map<size_t, FileResult> done_;
  size_t next_to_read_ = 0;     // next file index handed to a worker
  size_t next_to_deliver_ = 0;  // next file index owed to the consumer
  bool stop_ = false;

  // consumer-side state (single-threaded consumer)
  FileResult current_;
  size_t rec_idx_ = 0;
  std::string last_error_;
};

}  // namespace

extern "C" {

void* mml_open_reader(const char* root, int recursive, const char* pattern,
                      double sample_ratio, uint64_t seed, int inspect_zip,
                      int n_threads, int max_outstanding) {
  try {
    return new Reader(root ? root : "", recursive != 0,
                      pattern ? pattern : "", sample_ratio, seed,
                      inspect_zip != 0, n_threads, max_outstanding);
  } catch (...) {
    return nullptr;
  }
}

int mml_next_record(void* r, const char** path, const void** data,
                    int64_t* size) {
  return static_cast<Reader*>(r)->next(path, data, size);
}

const char* mml_last_error(void* r) {
  return static_cast<Reader*>(r)->last_error();
}

int64_t mml_n_files(void* r) { return static_cast<Reader*>(r)->n_files(); }

void mml_close_reader(void* r) { delete static_cast<Reader*>(r); }

int mml_abi_version() { return 1; }

}  // extern "C"

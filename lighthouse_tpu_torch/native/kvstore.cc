// Embedded log-structured KV store (the LevelDB seat of reference
// beacon_node/store/src/leveldb_store.rs, reimplemented as a TPU-host
// native component; see SURVEY.md native-code census item 2).
//
// Design: single append-only log file + in-memory index.
//   record := u32 crc | u8 op | u16 col_len | u32 key_len | u32 val_len
//             | col | key | val
// Writes append records; deletes append tombstones; an atomic batch is a
// BATCH_BEGIN record, the member records, and a BATCH_COMMIT record --
// replay ignores a batch with no commit, giving all-or-nothing crash
// semantics (the do_atomically contract of store/src/lib.rs). Open replays
// the log into the index; compact() rewrites only live records.
//
// Exposed as a C ABI for ctypes (no pybind11 in the image).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <vector>

#ifndef _WIN32
#include <fcntl.h>
#include <unistd.h>
#endif

namespace {

constexpr uint8_t OP_PUT = 1;
constexpr uint8_t OP_DEL = 2;
constexpr uint8_t OP_BATCH_BEGIN = 3;
constexpr uint8_t OP_BATCH_COMMIT = 4;

uint32_t crc32(const uint8_t* data, size_t n) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Record {
  uint8_t op;
  std::string col, key, val;
};

void encode(const Record& r, std::vector<uint8_t>* out) {
  std::vector<uint8_t> body;
  body.push_back(r.op);
  uint16_t cl = static_cast<uint16_t>(r.col.size());
  uint32_t kl = static_cast<uint32_t>(r.key.size());
  uint32_t vl = static_cast<uint32_t>(r.val.size());
  body.insert(body.end(), reinterpret_cast<uint8_t*>(&cl),
              reinterpret_cast<uint8_t*>(&cl) + 2);
  body.insert(body.end(), reinterpret_cast<uint8_t*>(&kl),
              reinterpret_cast<uint8_t*>(&kl) + 4);
  body.insert(body.end(), reinterpret_cast<uint8_t*>(&vl),
              reinterpret_cast<uint8_t*>(&vl) + 4);
  body.insert(body.end(), r.col.begin(), r.col.end());
  body.insert(body.end(), r.key.begin(), r.key.end());
  body.insert(body.end(), r.val.begin(), r.val.end());
  uint32_t crc = crc32(body.data(), body.size());
  out->insert(out->end(), reinterpret_cast<uint8_t*>(&crc),
              reinterpret_cast<uint8_t*>(&crc) + 4);
  out->insert(out->end(), body.begin(), body.end());
}

struct Db {
  std::string path;
  FILE* log = nullptr;
  // open-time recovery outcomes (surfaced to the host's metrics registry
  // via kv_recovery_stats): committed batches re-applied, uncommitted
  // batches dropped, torn-tail bytes truncated
  uint64_t replayed_batches = 0;
  uint64_t rolled_back_batches = 0;
  uint64_t truncated_bytes = 0;
  // (col, key) -> value; tombstoned entries removed
  std::map<std::pair<std::string, std::string>, std::string> index;

  bool apply(const Record& r) {
    auto k = std::make_pair(r.col, r.key);
    if (r.op == OP_PUT) {
      index[k] = r.val;
      return true;
    }
    if (r.op == OP_DEL) {
      index.erase(k);
      return true;
    }
    return false;
  }
};

bool read_exact(FILE* f, void* buf, size_t n) {
  return fread(buf, 1, n, f) == n;
}

// replay the log; truncated/corrupt tails and uncommitted batches are
// dropped (crash recovery)
void replay(Db* db) {
  FILE* f = fopen(db->path.c_str(), "rb");
  if (!f) return;
  fseek(f, 0, SEEK_END);
  long file_size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<Record> pending;
  bool in_batch = false;
  long good_end = 0;
  for (;;) {
    uint32_t crc;
    if (!read_exact(f, &crc, 4)) break;
    uint8_t op;
    uint16_t cl;
    uint32_t kl, vl;
    if (!read_exact(f, &op, 1) || !read_exact(f, &cl, 2) ||
        !read_exact(f, &kl, 4) || !read_exact(f, &vl, 4))
      break;
    // length sanity BEFORE allocating/indexing: a corrupt length field
    // must take the truncate-the-tail path, not wrap the arithmetic or
    // allocate gigabytes inside crash recovery
    uint64_t payload = uint64_t(cl) + uint64_t(kl) + uint64_t(vl);
    if (payload > uint64_t(file_size) - uint64_t(ftell(f)) ||
        payload > (1ull << 31))
      break;
    std::vector<uint8_t> body(1 + 2 + 4 + 4 + payload);
    body[0] = op;
    memcpy(&body[1], &cl, 2);
    memcpy(&body[3], &kl, 4);
    memcpy(&body[7], &vl, 4);
    if (payload > 0 && !read_exact(f, &body[11], payload)) break;
    if (crc32(body.data(), body.size()) != crc) break;
    Record r;
    r.op = op;
    r.col.assign(reinterpret_cast<char*>(&body[11]), cl);
    r.key.assign(reinterpret_cast<char*>(&body[11 + cl]), kl);
    r.val.assign(reinterpret_cast<char*>(&body[11 + cl + kl]), vl);
    if (op == OP_BATCH_BEGIN) {
      if (in_batch) db->rolled_back_batches++;  // begin with no commit
      in_batch = true;
      pending.clear();
    } else if (op == OP_BATCH_COMMIT) {
      for (const auto& p : pending) db->apply(p);
      pending.clear();
      if (in_batch) db->replayed_batches++;
      in_batch = false;
      good_end = ftell(f);
    } else if (in_batch) {
      pending.push_back(r);
    } else {
      db->apply(r);
      good_end = ftell(f);
    }
  }
  if (in_batch) db->rolled_back_batches++;  // crash mid-batch: dropped
  fclose(f);
  // drop any torn tail so future appends start at a clean boundary
  FILE* t = fopen(db->path.c_str(), "rb+");
  if (t) {
    fseek(t, 0, SEEK_END);
    if (ftell(t) != good_end) {
      db->truncated_bytes += uint64_t(ftell(t) - good_end);
      fflush(t);
#ifdef _WIN32
      (void)good_end;
#else
      if (ftruncate(fileno(t), good_end) != 0) { /* best effort */ }
#endif
    }
    fclose(t);
  }
}

// flush=true pushes to the page cache (process-crash safety, LevelDB's
// default non-sync write); barrier=true adds fdatasync -- paid only by
// batch commits so the block-import hot path isn't 3 disk barriers/block
void append(Db* db, const std::vector<uint8_t>& buf, bool flush,
            bool barrier = false) {
  fwrite(buf.data(), 1, buf.size(), db->log);
  if (flush) fflush(db->log);
#ifndef _WIN32
  if (barrier) fdatasync(fileno(db->log));
#endif
}

}  // namespace

extern "C" {

void* kv_open(const char* path) {
  Db* db = new Db();
  db->path = path;
  replay(db);
  db->log = fopen(path, "ab");
  if (!db->log) {
    delete db;
    return nullptr;
  }
  return db;
}

void kv_close(void* h) {
  Db* db = static_cast<Db*>(h);
  if (db->log) fclose(db->log);
  delete db;
}

void kv_put(void* h, const char* col, size_t cl, const char* key, size_t kl,
            const char* val, size_t vl) {
  Db* db = static_cast<Db*>(h);
  Record r{OP_PUT, std::string(col, cl), std::string(key, kl),
           std::string(val, vl)};
  std::vector<uint8_t> buf;
  encode(r, &buf);
  append(db, buf, true);
  db->apply(r);
}

void kv_delete(void* h, const char* col, size_t cl, const char* key,
               size_t kl) {
  Db* db = static_cast<Db*>(h);
  Record r{OP_DEL, std::string(col, cl), std::string(key, kl), ""};
  std::vector<uint8_t> buf;
  encode(r, &buf);
  append(db, buf, true);
  db->apply(r);
}

// value length or -1; copies up to cap bytes into out
long kv_get(void* h, const char* col, size_t cl, const char* key, size_t kl,
            char* out, size_t cap) {
  Db* db = static_cast<Db*>(h);
  auto it = db->index.find({std::string(col, cl), std::string(key, kl)});
  if (it == db->index.end()) return -1;
  const std::string& v = it->second;
  if (out && cap >= v.size()) memcpy(out, v.data(), v.size());
  return static_cast<long>(v.size());
}

// batch: ops encoded by the caller as a sequence of (op, col, key, val);
// framed between BATCH_BEGIN / BATCH_COMMIT with ONE flush at commit
void kv_batch_begin(void* h) {
  Db* db = static_cast<Db*>(h);
  Record r{OP_BATCH_BEGIN, "", "", ""};
  std::vector<uint8_t> buf;
  encode(r, &buf);
  append(db, buf, false);
}

void kv_batch_put(void* h, const char* col, size_t cl, const char* key,
                  size_t kl, const char* val, size_t vl) {
  Db* db = static_cast<Db*>(h);
  Record r{OP_PUT, std::string(col, cl), std::string(key, kl),
           std::string(val, vl)};
  std::vector<uint8_t> buf;
  encode(r, &buf);
  append(db, buf, false);
  db->apply(r);  // applied in-memory immediately; log commit seals it
}

void kv_batch_delete(void* h, const char* col, size_t cl, const char* key,
                     size_t kl) {
  Db* db = static_cast<Db*>(h);
  Record r{OP_DEL, std::string(col, cl), std::string(key, kl), ""};
  std::vector<uint8_t> buf;
  encode(r, &buf);
  append(db, buf, false);
  db->apply(r);
}

void kv_batch_commit(void* h) {
  Db* db = static_cast<Db*>(h);
  Record r{OP_BATCH_COMMIT, "", "", ""};
  std::vector<uint8_t> buf;
  encode(r, &buf);
  append(db, buf, true, /*barrier=*/true);
}

// iterate keys of a column: calls back with (key_ptr, key_len)
typedef void (*kv_key_cb)(const char*, size_t, void*);
void kv_keys(void* h, const char* col, size_t cl, kv_key_cb cb, void* ctx) {
  Db* db = static_cast<Db*>(h);
  std::string c(col, cl);
  auto it = db->index.lower_bound({c, ""});
  for (; it != db->index.end() && it->first.first == c; ++it) {
    cb(it->first.second.data(), it->first.second.size(), ctx);
  }
}

// rewrite the log with only live records (freezer-style compaction)
int kv_compact(void* h) {
  Db* db = static_cast<Db*>(h);
  std::string tmp = db->path + ".compact";
  FILE* out = fopen(tmp.c_str(), "wb");
  if (!out) return -1;
  bool write_ok = true;
  for (const auto& kv : db->index) {
    Record r{OP_PUT, kv.first.first, kv.first.second, kv.second};
    std::vector<uint8_t> buf;
    encode(r, &buf);
    if (fwrite(buf.data(), 1, buf.size(), out) != buf.size()) write_ok = false;
  }
  if (fflush(out) != 0) write_ok = false;
#ifndef _WIN32
  // the rename must never expose an unsynced replacement: power loss
  // after rename would otherwise lose the WHOLE database
  if (fdatasync(fileno(out)) != 0) write_ok = false;
#endif
  if (ferror(out)) write_ok = false;
  fclose(out);
  if (!write_ok) {
    // disk full / IO error: keep the good live log, drop the torn copy
    remove(tmp.c_str());
    return -1;
  }
  fclose(db->log);
  if (rename(tmp.c_str(), db->path.c_str()) != 0) {
    db->log = fopen(db->path.c_str(), "ab");
    return db->log ? -1 : -2;  // -2: log handle lost, db unusable
  }
#ifndef _WIN32
  // fsync the parent directory so the rename itself is durable; without
  // it a post-compaction committed batch can vanish with the new inode
  std::string dir = db->path;
  size_t slash = dir.find_last_of('/');
  dir = (slash == std::string::npos) ? std::string(".") : dir.substr(0, slash);
  int dfd = open(dir.c_str(), O_RDONLY | O_DIRECTORY);
  if (dfd >= 0) {
    fsync(dfd);
    close(dfd);
  }
#endif
  db->log = fopen(db->path.c_str(), "ab");
  return db->log ? 0 : -2;
}

size_t kv_len(void* h) {
  return static_cast<Db*>(h)->index.size();
}

// open-time recovery outcomes (counted once, during kv_open's replay):
// committed batches re-applied, uncommitted batches dropped, torn-tail
// bytes truncated. The host surfaces these into its metrics registry.
void kv_recovery_stats(void* h, uint64_t* replayed, uint64_t* rolled_back,
                       uint64_t* truncated_bytes) {
  Db* db = static_cast<Db*>(h);
  if (replayed) *replayed = db->replayed_batches;
  if (rolled_back) *rolled_back = db->rolled_back_batches;
  if (truncated_bytes) *truncated_bytes = db->truncated_bytes;
}

}  // extern "C"

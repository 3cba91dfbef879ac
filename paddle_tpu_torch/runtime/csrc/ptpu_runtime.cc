// Copied from paddle_tpu/runtime/ptpu_runtime.cc (host-only C++); it differs in comments and in two includes, <cctype> and <string>, which GCC 13's headers no longer pull in through the others. The port keeps its own copy so that it never reads paddle_tpu.
// paddle_tpu native host runtime.
//
// TPU-native analogue of the reference's C++ data pipeline + host allocator
// (ref: paddle/fluid/operators/reader/blocking_queue.h,
//  paddle/fluid/memory/allocation/auto_growth_best_fit_allocator.cc,
//  paddle/fluid/framework/blocking_queue.h).
//
// Two pieces, exported with a plain C ABI for ctypes:
//
//  * Host memory pool — size-class auto-growth allocator for staging
//    buffers that sit between DataLoader workers and the device transfer.
//    Keeps allocation out of the per-batch hot path and reports the same
//    kind of statistics the reference's allocator facade exposes
//    (in-use / peak / reserved / allocation counts).
//
//  * Data ring — bounded MPMC blocking queue of staged batches.  Producers
//    (Python worker threads) gather a batch's arrays into ONE pool slab
//    with a single C-side memcpy pass (GIL released by ctypes), consumers
//    pop slabs FIFO and hand bytes to the device.  This is the overlap
//    mechanism: host collation/copy runs concurrently with the device step.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread (see ../build.py).

#include <atomic>
#include <cctype>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <new>
#include <string>
#include <unordered_map>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Host memory pool
// ---------------------------------------------------------------------------

inline uint64_t size_class(uint64_t n) {
  uint64_t c = 256;
  while (c < n) c <<= 1;
  return c;
}

struct Pool {
  std::mutex mu;
  std::map<uint64_t, std::vector<char*>> free_lists;  // size class -> blocks
  std::unordered_map<void*, uint64_t> block_class;    // live block -> class
  uint64_t reserved = 0;      // total bytes obtained from the OS
  uint64_t in_use = 0;        // bytes handed out (class-rounded)
  uint64_t peak_in_use = 0;
  uint64_t alloc_count = 0;   // pool_alloc calls
  uint64_t grow_count = 0;    // OS allocations (cache misses)
  uint64_t free_count = 0;

  ~Pool() {
    for (auto& kv : free_lists)
      for (char* p : kv.second) ::operator delete[](p, std::nothrow);
    for (auto& kv : block_class) ::operator delete[]((char*)kv.first,
                                                     std::nothrow);
  }

  void* alloc(uint64_t n) {
    uint64_t cls = size_class(n);
    std::lock_guard<std::mutex> g(mu);
    alloc_count++;
    char* p = nullptr;
    auto it = free_lists.find(cls);
    if (it != free_lists.end() && !it->second.empty()) {
      p = it->second.back();
      it->second.pop_back();
    } else {
      p = static_cast<char*>(::operator new[](cls, std::nothrow));
      if (p == nullptr) return nullptr;
      grow_count++;
      reserved += cls;
    }
    block_class[p] = cls;
    in_use += cls;
    if (in_use > peak_in_use) peak_in_use = in_use;
    return p;
  }

  void release(void* p) {
    std::lock_guard<std::mutex> g(mu);
    auto it = block_class.find(p);
    if (it == block_class.end()) return;  // double free / foreign pointer
    uint64_t cls = it->second;
    block_class.erase(it);
    in_use -= cls;
    free_count++;
    free_lists[cls].push_back(static_cast<char*>(p));
  }

  // Return every cached (free-list) block to the OS.  Blocks still
  // handed out are untouched — their release() later just re-caches
  // them.  Used by the graveyard path so a destroyed-but-unreclaimable
  // object pins only its shell, not its slabs.
  void trim() {
    std::lock_guard<std::mutex> g(mu);
    for (auto& kv : free_lists) {
      for (char* p : kv.second) {
        ::operator delete[](p, std::nothrow);
        reserved -= kv.first;
      }
      kv.second.clear();
    }
  }
};

// ---------------------------------------------------------------------------
// Data ring
// ---------------------------------------------------------------------------

struct Slab {
  void* data;
  uint64_t len;
  uint64_t tag;
};

struct Ring {
  explicit Ring(int capacity) : cap(capacity) {}
  Pool pool;
  std::mutex mu;
  std::condition_variable not_full;
  std::condition_variable not_empty;
  std::deque<Slab> q;
  int cap;
  int inflight = 0;  // producers that reserved a slot and are copying
  bool closed = false;
  uint64_t pushed = 0;
  uint64_t popped = 0;

  // codes: 0 ok, -1 closed, -2 timeout, -3 oom
  int push_gather(const void* const* srcs, const uint64_t* lens, int n,
                  uint64_t tag, int timeout_ms) {
    uint64_t total = 0;
    for (int i = 0; i < n; i++) total += lens[i];
    if (total == 0) total = 1;
    std::unique_lock<std::mutex> lk(mu);
    auto has_room = [&] { return (int)q.size() + inflight < cap || closed; };
    if (timeout_ms < 0) {
      not_full.wait(lk, has_room);
    } else if (!not_full.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                  has_room)) {
      return -2;
    }
    if (closed) return -1;
    inflight++;  // hard-bound the queue even while copying unlocked
    lk.unlock();
    // copy outside the lock: other producers/consumers keep moving
    char* slab = static_cast<char*>(pool.alloc(total));
    if (slab == nullptr) {
      lk.lock();
      inflight--;
      lk.unlock();
      // the freed reservation may be the room another producer waits
      // for: without this wake it can sleep forever (missed wakeup)
      not_full.notify_one();
      return -3;
    }
    uint64_t off = 0;
    for (int i = 0; i < n; i++) {
      std::memcpy(slab + off, srcs[i], lens[i]);
      off += lens[i];
    }
    lk.lock();
    inflight--;
    if (closed) {  // closed while copying
      lk.unlock();
      pool.release(slab);
      not_full.notify_one();
      return -1;
    }
    q.push_back(Slab{slab, total, tag});
    pushed++;
    lk.unlock();
    not_empty.notify_one();
    return 0;
  }

  int pop(void** out_ptr, uint64_t* out_len, uint64_t* out_tag,
          int timeout_ms) {
    std::unique_lock<std::mutex> lk(mu);
    auto ready = [&] { return !q.empty() || closed; };
    if (timeout_ms < 0) {
      not_empty.wait(lk, ready);
    } else if (!not_empty.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                   ready)) {
      return -2;
    }
    if (q.empty()) return -1;  // closed and drained
    Slab s = q.front();
    q.pop_front();
    popped++;
    lk.unlock();
    not_full.notify_one();
    *out_ptr = s.data;
    *out_len = s.len;
    *out_tag = s.tag;
    return 0;
  }

  void close() {
    {
      std::lock_guard<std::mutex> g(mu);
      closed = true;
    }
    not_full.notify_all();
    not_empty.notify_all();
  }
};

std::mutex g_mu;
std::unordered_map<int64_t, Pool*> g_pools;
std::unordered_map<int64_t, Ring*> g_rings;
std::atomic<int64_t> g_next{1};

Pool* get_pool(int64_t h) {
  std::lock_guard<std::mutex> g(g_mu);
  auto it = g_pools.find(h);
  return it == g_pools.end() ? nullptr : it->second;
}

Ring* get_ring(int64_t h) {
  std::lock_guard<std::mutex> g(g_mu);
  auto it = g_rings.find(h);
  return it == g_rings.end() ? nullptr : it->second;
}

}  // namespace

extern "C" {

// ---- pool ----
int64_t ptpu_pool_create() {
  int64_t h = g_next++;
  std::lock_guard<std::mutex> g(g_mu);
  g_pools[h] = new Pool();
  return h;
}

std::vector<Pool*>& pool_graveyard() {
  static std::vector<Pool*> g;
  return g;
}

void ptpu_pool_destroy(int64_t h) {
  Pool* p;
  {
    std::lock_guard<std::mutex> g(g_mu);
    auto it = g_pools.find(h);
    if (it == g_pools.end()) return;
    p = it->second;
    g_pools.erase(it);
    pool_graveyard().push_back(p);  // see ring_graveyard rationale
  }
  p->trim();  // cached blocks back to the OS; only the shell is pinned
}

void* ptpu_pool_alloc(int64_t h, uint64_t n) {
  Pool* p = get_pool(h);
  return p ? p->alloc(n) : nullptr;
}

void ptpu_pool_free(int64_t h, void* ptr) {
  Pool* p = get_pool(h);
  if (p) p->release(ptr);
}

// out[0..6] = reserved, in_use, peak_in_use, alloc_count, grow_count,
//             free_count
void ptpu_pool_stats(int64_t h, uint64_t* out) {
  Pool* p = get_pool(h);
  if (!p) { std::memset(out, 0, 6 * sizeof(uint64_t)); return; }
  std::lock_guard<std::mutex> g(p->mu);
  out[0] = p->reserved;
  out[1] = p->in_use;
  out[2] = p->peak_in_use;
  out[3] = p->alloc_count;
  out[4] = p->grow_count;
  out[5] = p->free_count;
}

// ---- ring ----
int64_t ptpu_ring_create(int capacity) {
  if (capacity <= 0) capacity = 2;
  int64_t h = g_next++;
  std::lock_guard<std::mutex> g(g_mu);
  g_rings[h] = new Ring(capacity);
  return h;
}

// Destroyed objects go to a graveyard instead of delete: another thread
// may still hold a raw pointer from get_ring()/get_pool() or be blocked
// on the ring's condvars — deleting under it is a use-after-free.  close()
// wakes every waiter and all later ops fail cleanly via the erased handle;
// the object itself (a few hundred bytes + its pool, whose slabs ARE
// freed by close/release) lives until process exit.  Rings are created
// per-DataLoader-epoch at most — the leak is bounded and tiny.
std::vector<Ring*>& ring_graveyard() {
  static std::vector<Ring*> g;
  return g;
}

void ptpu_ring_destroy(int64_t h) {
  Ring* r;
  {
    std::lock_guard<std::mutex> g(g_mu);
    auto it = g_rings.find(h);
    if (it == g_rings.end()) return;
    r = it->second;
    g_rings.erase(it);
  }
  r->close();
  // reclaim the actual memory: drain queued slabs into the pool's free
  // lists, then trim those to the OS.  A racing producer mid-copy still
  // holds its own slab; its release() lands in the (trimmed-later-never)
  // free list — bytes bounded by in-flight batches at destroy time.
  {
    std::lock_guard<std::mutex> lk(r->mu);
    for (auto& s : r->q) r->pool.release(s.data);
    r->q.clear();
  }
  r->pool.trim();
  {
    std::lock_guard<std::mutex> g(g_mu);
    ring_graveyard().push_back(r);
  }
}

int ptpu_ring_push_gather(int64_t h, const void* const* srcs,
                          const uint64_t* lens, int n, uint64_t tag,
                          int timeout_ms) {
  Ring* r = get_ring(h);
  return r ? r->push_gather(srcs, lens, n, tag, timeout_ms) : -1;
}

int ptpu_ring_pop(int64_t h, void** out_ptr, uint64_t* out_len,
                  uint64_t* out_tag, int timeout_ms) {
  Ring* r = get_ring(h);
  return r ? r->pop(out_ptr, out_len, out_tag, timeout_ms) : -1;
}

void ptpu_ring_release(int64_t h, void* ptr) {
  Ring* r = get_ring(h);
  if (r) r->pool.release(ptr);
}

void ptpu_ring_close(int64_t h) {
  Ring* r = get_ring(h);
  if (r) r->close();
}

int ptpu_ring_size(int64_t h) {
  Ring* r = get_ring(h);
  if (!r) return -1;
  std::lock_guard<std::mutex> g(r->mu);
  return (int)r->q.size();
}

void ptpu_ring_stats(int64_t h, uint64_t* out) {
  Ring* r = get_ring(h);
  if (!r) { std::memset(out, 0, 8 * sizeof(uint64_t)); return; }
  std::lock_guard<std::mutex> g(r->mu);
  out[0] = r->pushed;
  out[1] = r->popped;
  {
    std::lock_guard<std::mutex> pg(r->pool.mu);
    out[2] = r->pool.reserved;
    out[3] = r->pool.in_use;
    out[4] = r->pool.peak_in_use;
    out[5] = r->pool.alloc_count;
    out[6] = r->pool.grow_count;
    out[7] = r->pool.free_count;
  }
}

// ---- fused image preprocess ----
//
// The reference's vision data path does uint8 decode -> float normalize ->
// HWC->CHW transpose per image in Python workers (ref:
// python/paddle/vision/transforms/functional.py::normalize/to_tensor);
// this fuses all three into one threaded C pass so DataLoader collation
// feeds the host->HBM staging ring at memory bandwidth.
//
// srcs: n pointers to u8 [H, W, C] images; out: f32 [n, C, H, W];
// out[i][ch][y][x] = (src[y][x][ch] * scale - mean[ch]) * inv_std[ch].
int ptpu_preprocess_u8_nhwc_to_f32_nchw(const uint8_t* const* srcs, int n,
                                        int h, int w, int c,
                                        const float* mean,
                                        const float* inv_std, float scale,
                                        float* out, int n_threads) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c > 16) return -1;
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int64_t img_out = plane * c;
  float pre_mul[16], pre_sub[16];
  for (int ch = 0; ch < c; ++ch) {
    pre_mul[ch] = scale * inv_std[ch];
    pre_sub[ch] = mean[ch] * inv_std[ch];
  }
  auto work = [&](int begin, int end) {
    for (int i = begin; i < end; ++i) {
      const uint8_t* src = srcs[i];
      float* dst = out + i * img_out;
      for (int64_t p = 0; p < plane; ++p) {
        const uint8_t* px = src + p * c;
        for (int ch = 0; ch < c; ++ch) {
          dst[ch * plane + p] = px[ch] * pre_mul[ch] - pre_sub[ch];
        }
      }
    }
  };
  int threads = n_threads > 0 ? n_threads : 1;
  if (threads > n) threads = n;
  if (threads <= 1) {
    work(0, n);
    return 0;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads);
  const int chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    const int b = t * chunk;
    const int e = b + chunk < n ? b + chunk : n;
    if (b >= e) break;
    pool.emplace_back(work, b, e);
  }
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// WordPiece tokenizer (ref: the ERNIE/BERT data pipeline's host-side
// tokenization — reference tokenization.py implements the same algorithm
// in Python; models feed int ids).  Basic tokenize (whitespace +
// punctuation split, optional ASCII lowercase) then greedy longest-match
// wordpiece with a "##" continuation prefix.  UTF-8 bytes outside ASCII
// pass through opaquely (multi-byte chars are treated as atomic units).
namespace wp {

struct Tok {
  std::unordered_map<std::string, int> vocab;
  int unk_id = 0;
  std::string cont = "##";
};

std::unordered_map<int64_t, Tok*> g_toks;

inline bool is_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// one UTF-8 character's byte length from its lead byte
inline int u8len(unsigned char c) {
  if (c < 0x80) return 1;
  if ((c >> 5) == 0x6) return 2;
  if ((c >> 4) == 0xE) return 3;
  if ((c >> 3) == 0x1E) return 4;
  return 1;
}

void wordpiece(const Tok& tk, const std::string& word,
               std::vector<int>* out) {
  if (word.empty()) return;
  size_t start = 0;
  std::vector<int> pieces;
  while (start < word.size()) {
    size_t end = word.size();
    int found = -1;
    size_t found_end = start;
    while (end > start) {
      std::string sub = word.substr(start, end - start);
      if (start > 0) sub = tk.cont + sub;
      auto it = tk.vocab.find(sub);
      if (it != tk.vocab.end()) { found = it->second; found_end = end; break; }
      // shrink by one UTF-8 char from the right
      size_t e = start;
      size_t prev = start;
      while (e < end) { prev = e; e += u8len((unsigned char)word[e]); }
      end = prev;
    }
    if (found < 0) { out->push_back(tk.unk_id); return; }
    pieces.push_back(found);
    start = found_end;
  }
  out->insert(out->end(), pieces.begin(), pieces.end());
}

}  // namespace wp

extern "C" {

int64_t ptpu_wp_create(const char* vocab_data, int64_t len,
                       const char* unk_token) {
  auto* tk = new wp::Tok();
  // vocab: newline-separated tokens; line index = id
  int id = 0;
  const char* p = vocab_data;
  const char* endp = vocab_data + len;
  while (p < endp) {
    const char* nl = (const char*)memchr(p, '\n', endp - p);
    size_t n = nl ? (size_t)(nl - p) : (size_t)(endp - p);
    while (n > 0 && (p[n - 1] == '\r')) --n;
    // LAST duplicate wins, matching the Python dict load (reference
    // tokenization.py reads sequentially with plain assignment)
    if (n > 0) tk->vocab[std::string(p, n)] = id;
    ++id;
    if (!nl) break;
    p = nl + 1;
  }
  auto it = tk->vocab.find(unk_token ? unk_token : "[UNK]");
  tk->unk_id = it == tk->vocab.end() ? 0 : it->second;
  int64_t h = g_next++;
  std::lock_guard<std::mutex> g(g_mu);
  wp::g_toks[h] = tk;
  return h;
}

std::vector<wp::Tok*>& tok_graveyard() {
  static std::vector<wp::Tok*> g;
  return g;
}

void ptpu_wp_destroy(int64_t h) {
  wp::Tok* t;
  {
    std::lock_guard<std::mutex> g(g_mu);
    auto it = wp::g_toks.find(h);
    if (it == wp::g_toks.end()) return;
    t = it->second;
    wp::g_toks.erase(it);
    tok_graveyard().push_back(t);  // see ring_graveyard rationale
  }
}

int64_t ptpu_wp_encode(int64_t h, const char* text, int64_t text_len,
                       int do_lower, int* out_ids, int64_t max_out) {
  wp::Tok* tk;
  {
    std::lock_guard<std::mutex> g(g_mu);
    auto it = wp::g_toks.find(h);
    if (it == wp::g_toks.end()) return -1;
    tk = it->second;
  }
  std::vector<int> ids;
  std::string word;
  auto flush = [&]() {
    if (!word.empty()) { wp::wordpiece(*tk, word, &ids); word.clear(); }
  };
  int64_t i = 0;
  while (i < text_len) {
    unsigned char c = (unsigned char)text[i];
    if (c < 0x80) {
      // match Python str.isspace for ASCII: 9-13, 28-31, 32
      if (c == 32 || (c >= 9 && c <= 13) || (c >= 28 && c <= 31)) {
        flush(); ++i; continue;
      }
      if (wp::is_punct(c)) {
        flush();
        word.assign(1, (char)c);
        flush();
        ++i;
        continue;
      }
      word.push_back(do_lower ? (char)tolower(c) : (char)c);
      ++i;
    } else {
      int n = wp::u8len(c);
      for (int k = 0; k < n && i < text_len; ++k, ++i)
        word.push_back(text[i]);
    }
  }
  flush();
  int64_t n = (int64_t)ids.size() < max_out ? (int64_t)ids.size() : max_out;
  for (int64_t k = 0; k < n; ++k) out_ids[k] = ids[k];
  return (int64_t)ids.size();
}

}  // extern "C"


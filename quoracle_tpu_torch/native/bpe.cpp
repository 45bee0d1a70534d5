// Byte-level BPE encoder/decoder/counter.
//
// The port's copy of quoracle_tpu/native/bpe.cpp. Loaded through ctypes
// by quoracle_tpu_torch/native/tokenizer.py, which hands it the port's
// merges file (quoracle_tpu_torch/models/bpe_merges.txt); the pure-Python
// fallback there implements the identical algorithm, so both sides must
// stay in lockstep:
//
//   ids:    0..2 specials, 3..258 bytes (b+3), 259+ merges by rank
//   units:  pre-split at whitespace->word boundaries; newline closes a
//           unit; units cap at 128 bytes (must match pre_split)
//   encode: within each unit, repeatedly apply the lowest-rank adjacent
//           merge (heap + linked list, O(n log n) per unit)
//
// Build (native/__init__.py does it at first use, into build/native/):
//   g++ -O2 -shared -fPIC -o libqtbpe.so bpe.cpp

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kSpecials = 3;
constexpr int kByteBase = kSpecials;          // byte b -> id b+3
constexpr int kFirstMergeId = kByteBase + 256;
constexpr int kMaxWordLen = 128;

struct Bpe {
  // (left<<32 | right) -> rank
  std::unordered_map<uint64_t, int32_t> ranks;
  std::vector<std::pair<int32_t, int32_t>> merges;  // rank -> (l, r)
  std::vector<std::string> expansions;              // id -> utf8 bytes
  int32_t n_merges = 0;                             // total loaded

  int32_t merge_id(int32_t rank) const { return kFirstMergeId + rank; }
};

uint64_t PairKey(int32_t a, int32_t b) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
         static_cast<uint32_t>(b);
}

// Encode one pre-split unit in place into `out`. `max_merges` bounds the
// active rank prefix per call — the shared Bpe is never mutated, so
// concurrent encodes with different vocab sizes cannot race.
void EncodeUnit(const Bpe &bpe, int32_t max_merges, const uint8_t *data,
                size_t len, std::vector<int32_t> *out) {
  if (len == 0) return;
  if (len == 1) {
    out->push_back(kByteBase + data[0]);
    return;
  }
  std::vector<int32_t> ids(len);
  std::vector<int32_t> prev(len), next(len);
  std::vector<bool> alive(len, true);
  for (size_t i = 0; i < len; ++i) {
    ids[i] = kByteBase + data[i];
    prev[i] = static_cast<int32_t>(i) - 1;
    next[i] = (i + 1 < len) ? static_cast<int32_t>(i + 1) : -1;
  }
  struct Cand {
    int32_t rank, pos, right;  // merge at pos with its right neighbor
    bool operator>(const Cand &o) const {
      return rank != o.rank ? rank > o.rank : pos > o.pos;
    }
  };
  std::priority_queue<Cand, std::vector<Cand>, std::greater<Cand>> heap;
  auto push_pair = [&](int32_t pos) {
    int32_t r = next[pos];
    if (pos < 0 || r < 0) return;
    auto it = bpe.ranks.find(PairKey(ids[pos], ids[r]));
    if (it != bpe.ranks.end() && it->second < max_merges)
      heap.push({it->second, pos, r});
  };
  for (size_t i = 0; i + 1 < len; ++i) push_pair(static_cast<int32_t>(i));

  while (!heap.empty()) {
    Cand c = heap.top();
    heap.pop();
    // stale? (either side merged away, or ids changed since push)
    if (!alive[c.pos] || next[c.pos] != c.right || !alive[c.right]) continue;
    auto it = bpe.ranks.find(PairKey(ids[c.pos], ids[c.right]));
    if (it == bpe.ranks.end() || it->second != c.rank) continue;
    ids[c.pos] = bpe.merge_id(c.rank);
    alive[c.right] = false;
    int32_t rr = next[c.right];
    next[c.pos] = rr;
    if (rr >= 0) prev[rr] = c.pos;
    if (prev[c.pos] >= 0) push_pair(prev[c.pos]);
    push_pair(c.pos);
  }
  for (int32_t i = 0; i >= 0 && static_cast<size_t>(i) < len; i = next[i])
    if (alive[i]) out->push_back(ids[i]);
}

bool IsSpace(uint8_t b) {
  return b == ' ' || b == '\t' || b == '\n' || b == '\r';
}

void Encode(const Bpe &bpe, int32_t max_merges, const uint8_t *data,
            size_t len, std::vector<int32_t> *out) {
  // pre-split mirror of train_bpe.pre_split
  size_t start = 0;
  bool in_space = true;
  for (size_t i = 0; i < len; ++i) {
    uint8_t b = data[i];
    bool is_space = IsSpace(b);
    if (is_space && !in_space) {
      EncodeUnit(bpe, max_merges, data + start, i - start, out);
      start = i;
    } else if (b == '\n') {
      EncodeUnit(bpe, max_merges, data + start, i + 1 - start, out);
      start = i + 1;
      in_space = true;
      continue;
    }
    if (i - start >= kMaxWordLen) {
      EncodeUnit(bpe, max_merges, data + start, i - start, out);
      start = i;
    }
    in_space = is_space;
  }
  if (start < len) EncodeUnit(bpe, max_merges, data + start, len - start, out);
}

}  // namespace

extern "C" {

void *qt_bpe_load(const char *merges_path) {
  FILE *f = fopen(merges_path, "r");
  if (!f) return nullptr;
  auto *bpe = new Bpe();
  bpe->expansions.resize(kFirstMergeId);
  for (int b = 0; b < 256; ++b)
    bpe->expansions[kByteBase + b] = std::string(1, static_cast<char>(b));
  char line[256];
  int32_t rank = 0;
  while (fgets(line, sizeof(line), f)) {
    if (line[0] == '#' || line[0] == '\n') continue;
    long a, b;
    if (sscanf(line, "%ld %ld", &a, &b) != 2) continue;
    bpe->ranks[PairKey(static_cast<int32_t>(a), static_cast<int32_t>(b))] =
        rank;
    bpe->merges.emplace_back(a, b);
    bpe->expansions.push_back(bpe->expansions[a] + bpe->expansions[b]);
    ++rank;
  }
  fclose(f);
  bpe->n_merges = rank;
  return bpe;
}

void qt_bpe_free(void *handle) { delete static_cast<Bpe *>(handle); }

int32_t qt_bpe_n_merges(void *handle) {
  return static_cast<Bpe *>(handle)->n_merges;
}

// Encode with the first `n_merges` merges only (per-model vocab prefix).
// Returns number of ids written (clamped to max_out); -1 on error.
int64_t qt_bpe_encode(void *handle, const uint8_t *text, int64_t len,
                      int32_t n_merges, int32_t *out, int64_t max_out) {
  auto *bpe = static_cast<Bpe *>(handle);
  int32_t active = bpe->n_merges;
  if (n_merges >= 0 && n_merges < active) active = n_merges;
  std::vector<int32_t> ids;
  ids.reserve(len / 3 + 8);
  Encode(*bpe, active, text, static_cast<size_t>(len), &ids);
  int64_t n = static_cast<int64_t>(ids.size());
  if (out != nullptr) {
    int64_t w = n < max_out ? n : max_out;
    memcpy(out, ids.data(), w * sizeof(int32_t));
  }
  return n;
}

// Decode ids into utf8; returns bytes written (clamped); unknown ids skip.
int64_t qt_bpe_decode(void *handle, const int32_t *ids, int64_t n,
                      uint8_t *out, int64_t max_out) {
  auto *bpe = static_cast<Bpe *>(handle);
  int64_t w = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t id = ids[i];
    if (id < kByteBase ||
        id >= static_cast<int32_t>(bpe->expansions.size()))
      continue;
    const std::string &s = bpe->expansions[id];
    for (char ch : s) {
      if (w >= max_out) return w;
      out[w++] = static_cast<uint8_t>(ch);
    }
  }
  return w;
}

}  // extern "C"

// Native BPE encoder for fish-tts-tpu.
//
// Replaces the host-side tokenizer hot path that the reference outsources to
// tiktoken's Rust core (upstream fish-tts models/tokenizer.py:88-99):
// the Fish-Speech split pattern (tokenizer.py:11-22, including the literal
// "(\?!\S)" quirk at line 19) as a hand-rolled leftmost-first scanner, plus
// the byte-pair merge over mergeable ranks.  Special-token splitting stays in
// Python (fish_tts_tpu/native/bpe.py); this module only sees ordinary text.
//
// Pattern semantics replicated (Perl/fancy-regex leftmost-first alternation,
// greedy quantifiers; verified token-for-token against tiktoken in
// tests/test_native_bpe.py):
//   1. (?i:'s|'t|'re|'ve|'m|'ll|'d)
//   2. \p{P}
//   3. [^\r\n\p{L}\p{N}]?\p{L}+
//   4. \p{N}
//   5.  ?[^\s\p{L}\p{N}]+[\r\n]*
//   6. \s*[\r\n]+          (backtracks to end at the last CR/LF of the run)
//   7. \s+(\?!\S)          (literal "?!" — the reference's quirk, NOT a lookahead)
//   8. \s+
//
// Unicode classes come from unicode_tables.h (generated, Unicode 15.0.0);
// \s is the fixed Unicode White_Space list below.
//
// C ABI only — bound from Python via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string_view>
#include <unordered_map>
#include <vector>

#include "unicode_tables.h"

namespace {

constexpr uint32_t kNoRank = 0xFFFFFFFFu;

bool in_table(const CpRange* table, int n, uint32_t cp) {
  int lo = 0, hi = n - 1;
  while (lo <= hi) {
    int mid = (lo + hi) / 2;
    if (cp < table[mid].first) {
      hi = mid - 1;
    } else if (cp > table[mid].last) {
      lo = mid + 1;
    } else {
      return true;
    }
  }
  return false;
}

bool is_l(uint32_t cp) { return in_table(kTableL, kTableL_len, cp); }
bool is_n(uint32_t cp) { return in_table(kTableN, kTableN_len, cp); }
bool is_p(uint32_t cp) { return in_table(kTableP, kTableP_len, cp); }

// Unicode White_Space property (what \s means in tiktoken's regex engine).
bool is_ws(uint32_t cp) {
  switch (cp) {
    case 0x09: case 0x0A: case 0x0B: case 0x0C: case 0x0D:
    case 0x20: case 0x85: case 0xA0: case 0x1680:
    case 0x2028: case 0x2029: case 0x202F: case 0x205F: case 0x3000:
      return true;
    default:
      return cp >= 0x2000 && cp <= 0x200A;
  }
}

bool is_crlf(uint32_t cp) { return cp == 0x0A || cp == 0x0D; }

// Case-fold a codepoint far enough to compare against the ASCII letters in
// alternative 1 ('s 't 're 've 'm 'll 'd).  U+017F LATIN SMALL LETTER LONG S
// folds to 's' under full Unicode case folding, which (?i:) applies.
uint32_t fold1(uint32_t cp) {
  if (cp >= 'A' && cp <= 'Z') return cp + 32;
  if (cp == 0x17F) return 's';
  return cp;
}

struct Vocab {
  std::vector<char> arena;  // stable storage for token bytes
  std::unordered_map<std::string_view, uint32_t> ranks;
};

uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // little-endian host assumed (x86/ARM); asserted Python-side
}

// ---------------------------------------------------------------------------
// Pre-tokenizer: decode UTF-8 once, then scan alternatives leftmost-first.
// ---------------------------------------------------------------------------

struct Decoded {
  std::vector<uint32_t> cp;      // codepoints
  std::vector<uint32_t> off;     // byte offset of each cp, plus end offset
};

bool decode_utf8(const uint8_t* s, size_t n, Decoded* out) {
  out->cp.reserve(n);
  out->off.reserve(n + 1);
  size_t i = 0;
  while (i < n) {
    out->off.push_back(static_cast<uint32_t>(i));
    uint8_t b = s[i];
    uint32_t cp;
    size_t len;
    if (b < 0x80) {
      cp = b; len = 1;
    } else if ((b & 0xE0) == 0xC0) {
      cp = b & 0x1F; len = 2;
    } else if ((b & 0xF0) == 0xE0) {
      cp = b & 0x0F; len = 3;
    } else if ((b & 0xF8) == 0xF0) {
      cp = b & 0x07; len = 4;
    } else {
      return false;
    }
    if (i + len > n) return false;
    for (size_t k = 1; k < len; k++) {
      if ((s[i + k] & 0xC0) != 0x80) return false;
      cp = (cp << 6) | (s[i + k] & 0x3F);
    }
    // Reject what a strict decoder must: overlong encodings, surrogate
    // codepoints, and values beyond U+10FFFF.  Unreachable from the Python
    // binding (str.encode emits valid UTF-8) but this symbol is a stable C
    // ABI whose contract says -1 on malformed input.
    if ((len == 2 && cp < 0x80) || (len == 3 && cp < 0x800) ||
        (len == 4 && cp < 0x10000) || (cp >= 0xD800 && cp <= 0xDFFF) ||
        cp > 0x10FFFF) {
      return false;
    }
    out->cp.push_back(cp);
    i += len;
  }
  out->off.push_back(static_cast<uint32_t>(n));
  return true;
}

// Try each alternative at codepoint index i; return match length in
// codepoints (0 = no alternative matched).
size_t match_at(const std::vector<uint32_t>& cp, size_t i) {
  const size_t n = cp.size();

  // 1. (?i:'s|'t|'re|'ve|'m|'ll|'d)
  if (cp[i] == '\'' && i + 1 < n) {
    uint32_t c1 = fold1(cp[i + 1]);
    uint32_t c2 = (i + 2 < n) ? fold1(cp[i + 2]) : 0;
    if (c1 == 's' || c1 == 't' || c1 == 'm' || c1 == 'd') return 2;
    if ((c1 == 'r' && c2 == 'e') || (c1 == 'v' && c2 == 'e') ||
        (c1 == 'l' && c2 == 'l'))
      return 3;
  }

  // 2. \p{P}
  if (is_p(cp[i])) return 1;

  // 3. [^\r\n\p{L}\p{N}]?\p{L}+   (greedy optional prefix first)
  {
    bool prefix_ok = !is_crlf(cp[i]) && !is_l(cp[i]) && !is_n(cp[i]);
    if (prefix_ok && i + 1 < n && is_l(cp[i + 1])) {
      size_t j = i + 1;
      while (j < n && is_l(cp[j])) j++;
      return j - i;
    }
    if (is_l(cp[i])) {
      size_t j = i;
      while (j < n && is_l(cp[j])) j++;
      return j - i;
    }
  }

  // 4. \p{N}
  if (is_n(cp[i])) return 1;

  // 5.  ?[^\s\p{L}\p{N}]+[\r\n]*
  {
    auto in5 = [](uint32_t c) { return !is_ws(c) && !is_l(c) && !is_n(c); };
    size_t j = i;
    if (cp[i] == ' ' && i + 1 < n && in5(cp[i + 1])) j = i + 1;
    if (in5(cp[j])) {
      while (j < n && in5(cp[j])) j++;
      while (j < n && is_crlf(cp[j])) j++;
      return j - i;
    }
  }

  // Whitespace run shared by alternatives 6-8.
  size_t w = i;
  while (w < n && is_ws(cp[w])) w++;
  if (w == i) return 0;

  // 6. \s*[\r\n]+ — longest \s* such that a [\r\n]+ run follows: ends one
  // past the LAST CR/LF inside the whitespace run.
  for (size_t j = w; j > i; j--) {
    if (is_crlf(cp[j - 1])) return j - i;
  }

  // 7. \s+(\?!\S) — whitespace run, then literal "?!", then one non-space.
  if (w + 2 < n && cp[w] == '?' && cp[w + 1] == '!' && !is_ws(cp[w + 2]))
    return (w - i) + 3;

  // 8. \s+
  return w - i;
}

// ---------------------------------------------------------------------------
// Byte-pair merge (tiktoken semantics: repeatedly merge the adjacent pair
// with the lowest rank, leftmost on ties, until no adjacent pair is in the
// vocab).  Pieces are word-sized, so the O(n^2) scan is plenty.
// ---------------------------------------------------------------------------

bool bpe_piece(const Vocab& v, const char* data, size_t len,
               std::vector<uint32_t>* out) {
  std::string_view whole(data, len);
  auto it = v.ranks.find(whole);
  if (it != v.ranks.end()) {
    out->push_back(it->second);
    return true;
  }
  // Part boundaries: starts[k] .. starts[k+1] is part k.
  std::vector<uint32_t> starts(len + 1);
  for (size_t i = 0; i <= len; i++) starts[i] = static_cast<uint32_t>(i);

  auto pair_rank = [&](size_t k) -> uint32_t {
    std::string_view sv(data + starts[k], starts[k + 2] - starts[k]);
    auto pit = v.ranks.find(sv);
    return pit == v.ranks.end() ? kNoRank : pit->second;
  };

  while (starts.size() > 2) {
    uint32_t best = kNoRank;
    size_t best_k = 0;
    for (size_t k = 0; k + 2 < starts.size(); k++) {
      uint32_t r = pair_rank(k);
      if (r < best) {
        best = r;
        best_k = k;
      }
    }
    if (best == kNoRank) break;
    starts.erase(starts.begin() + best_k + 1);
  }
  for (size_t k = 0; k + 1 < starts.size(); k++) {
    std::string_view sv(data + starts[k], starts[k + 1] - starts[k]);
    auto pit = v.ranks.find(sv);
    if (pit == v.ranks.end()) return false;  // incomplete byte-level vocab
    out->push_back(pit->second);
  }
  return true;
}

}  // namespace

extern "C" {

int ft_abi_version(void) { return 1; }

// blob: repeated (u32le token_len, token bytes, u32le rank) records.
// Exceptions must not cross the C ABI (ctypes would std::terminate) — all
// allocation failures surface as nullptr.
void* ft_bpe_new(const uint8_t* blob, size_t blob_len) try {
  std::unique_ptr<Vocab> v(new (std::nothrow) Vocab);
  if (!v) return nullptr;
  v->arena.reserve(blob_len);
  // First pass: copy token bytes into the arena (stable addresses).
  size_t i = 0;
  while (i + 4 <= blob_len) {
    uint32_t tlen = rd_u32(blob + i);
    i += 4;
    if (i + tlen + 4 > blob_len) return nullptr;
    v->arena.insert(v->arena.end(), blob + i, blob + i + tlen);
    i += tlen + 4;
  }
  if (i != blob_len) return nullptr;
  // Second pass: build views into the arena.
  size_t arena_pos = 0;
  i = 0;
  while (i + 4 <= blob_len) {
    uint32_t tlen = rd_u32(blob + i);
    i += 4;
    std::string_view key(v->arena.data() + arena_pos, tlen);
    arena_pos += tlen;
    i += tlen;
    v->ranks.emplace(key, rd_u32(blob + i));
    i += 4;
  }
  return v.release();
} catch (...) {
  return nullptr;
}

void ft_bpe_free(void* h) { delete static_cast<Vocab*>(h); }

void ft_ids_free(uint32_t* ids) { std::free(ids); }

// Encode ordinary UTF-8 text (no special tokens).  On success returns the
// token count and stores a malloc'd id array in *out (free with
// ft_ids_free); returns -1 on malformed UTF-8 / incomplete vocab / OOM.
int64_t ft_bpe_encode(const void* h, const uint8_t* utf8, size_t len,
                      uint32_t** out) try {
  const Vocab& v = *static_cast<const Vocab*>(h);
  Decoded d;
  if (!decode_utf8(utf8, len, &d)) return -1;

  std::vector<uint32_t> ids;
  ids.reserve(len / 3 + 4);
  const char* base = reinterpret_cast<const char*>(utf8);
  size_t i = 0;
  while (i < d.cp.size()) {
    size_t m = match_at(d.cp, i);
    if (m == 0) {
      i++;  // unreachable with this pattern (alts 2-8 cover all chars);
      continue;  // skip defensively like regex find_iter would
    }
    if (!bpe_piece(v, base + d.off[i], d.off[i + m] - d.off[i], &ids))
      return -1;
    i += m;
  }

  auto* buf = static_cast<uint32_t*>(std::malloc(sizeof(uint32_t) * (ids.size() + 1)));
  if (!buf) return -1;
  std::memcpy(buf, ids.data(), sizeof(uint32_t) * ids.size());
  *out = buf;
  return static_cast<int64_t>(ids.size());
} catch (...) {
  // std::bad_alloc (or anything else) must not unwind into ctypes
  return -1;
}

}  // extern "C"

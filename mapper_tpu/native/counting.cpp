// Native counting layer: the per-query match-vote state machine of
// Counting_HashBlockPath (reference: Counting_HashBlockPath.java — the
// Python oracle is mapper_tpu/align/candidates.py::CountingHashBlockPath,
// pinned by tests/test_native_counting.py's step-for-step differential).
//
// Inputs are the arrays the Python path already computes natively: the
// precomputed interesting-block walk (candidates.cpp::mapper_query_walk)
// and the fully-resolved prefetch (mapper_prefetch_fold: per walk block,
// the collision-filtered strand-folded (contig, offset, is_rc) match rows).
// This module replays those rows through the counter bookkeeping —
// neighbor-linked offset counters per (strand, contig), distinct-mismatch
// history scans, good/priority declaration — which profiling showed is the
// dominant Python cost of the sequential fallback worker.  All input arrays are BORROWED: the Python wrapper
// keeps them alive for the handle's lifetime.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <unordered_map>
#include <vector>

namespace {

struct Counter {
  int64_t offset;
  int32_t key_id;
  int32_t num_matches = 0;
  int64_t distinct;            // num_distinct_mismatches
  int64_t last_mismatched_pos; // last_mismatched_position
  int32_t last_matched = -1;   // history ordinal of last_matched_block
  int32_t history_index;
  bool good = false;
  int64_t priority = 0;
  int32_t prev = -1, next = -1; // neighbor counter ids within the indel window
};

struct KeyState {
  uint8_t is_rc;
  int64_t contig;
  int64_t seq_len; // len(sequence_b)
  std::vector<int64_t> offsets_sorted;
  std::vector<int32_t> ids_sorted;    // parallel to offsets_sorted
  std::vector<int32_t> ids_insertion; // dict-insertion order (by_offset.values())
};

struct CountingState {
  // borrowed inputs
  const int32_t* bstart;   // per walk row: block start
  const int32_t* bend;     // per walk row: block end (start + total length)
  const uint8_t* popular;  // per walk row: bin over cap -> skip entirely
  const int64_t* bounds;   // [nb+1] prefetch row ranges per walk block
  const int64_t* fold_idx; // per prefetch row: forward contig index
  const int64_t* fold_off; // per prefetch row: offset in forward coords
  const uint8_t* is_rc;    // per prefetch row: reverse-strand match
  const int64_t* seq_lengths; // per contig
  int64_t nb = 0;
  int64_t query_len = 0;
  int64_t max_indel = 0; // max_indel_length_to_consider
  int64_t usual = 1;     // USUAL_MATCHES_BEFORE_INVESTIGATING

  // runtime state
  int64_t feed_pos = 0;
  std::deque<int32_t> pending;
  std::vector<int32_t> hist_start, hist_end; // per processed-block ordinal
  int64_t num_blocks_anywhere = 0; // num_blocks_matching_anywhere
  int64_t max_nonoverlap = 0;      // max_nonoverlapping_block_visited
  int64_t num_nonoverlap = 0;      // num_nonoverlapping_blocks_visited
  int64_t min_distinct_memo = -1;
  bool done = false;
  bool found_good = false;
  std::vector<Counter> counters;
  std::vector<KeyState> keys;
  std::unordered_map<uint64_t, int32_t> key_lookup;
  std::vector<int32_t> good_list;
};

inline uint64_t key_of(uint8_t is_rc, int64_t contig) {
  return (uint64_t)contig * 2 + (is_rc ? 1 : 0);
}

// MatchCounter.update(): scan history from history_index, counting distinct
// mismatched non-overlapping blocks that fit inside the contig.
inline void counter_update(CountingState& S, Counter& c) {
  int32_t H = (int32_t)S.hist_start.size();
  int64_t seq_len = S.keys[c.key_id].seq_len;
  while (c.history_index < H) {
    int32_t i = c.history_index;
    if (i != c.last_matched) {
      if ((int64_t)S.hist_start[i] >= c.last_mismatched_pos) {
        if (c.offset + (int64_t)S.hist_end[i] <= seq_len) {
          c.distinct++;
          c.last_mismatched_pos = S.hist_end[i];
        }
      }
    }
    c.history_index++;
  }
}

inline void declare_good(CountingState& S, int32_t cid) {
  Counter& c = S.counters[cid];
  if (!c.good) {
    S.good_list.push_back(cid);
    c.good = true;
    counter_update(S, c);
    c.priority = c.distinct;
  }
}

inline void add_match(CountingState& S, int32_t cid, int32_t cur_ord) {
  Counter& c = S.counters[cid];
  c.num_matches++;
  c.last_matched = cur_ord;
  counter_update(S, c);
  if (c.num_matches == S.usual) {
    S.found_good = true;
    declare_good(S, cid);
  }
}

// Counting_HashBlockPath.updateMatches (java:193-252)
void update_matches(CountingState& S, uint8_t rc, int64_t contig, int64_t off,
                    int32_t cur_ord, int64_t cur_block_start) {
  uint64_t k = key_of(rc, contig);
  auto it = S.key_lookup.find(k);
  int32_t key_id;
  if (it == S.key_lookup.end()) {
    key_id = (int32_t)S.keys.size();
    S.key_lookup.emplace(k, key_id);
    KeyState ks;
    ks.is_rc = rc;
    ks.contig = contig;
    ks.seq_len = S.seq_lengths[contig];
    S.keys.push_back(std::move(ks));
  } else {
    key_id = it->second;
  }
  KeyState& ks = S.keys[key_id];

  // find or create the counter at this offset
  auto lo = std::lower_bound(ks.offsets_sorted.begin(), ks.offsets_sorted.end(), off);
  size_t pos = (size_t)(lo - ks.offsets_sorted.begin());
  int32_t cid;
  if (lo != ks.offsets_sorted.end() && *lo == off) {
    cid = ks.ids_sorted[pos];
  } else {
    cid = (int32_t)S.counters.size();
    Counter c;
    c.offset = off;
    c.key_id = key_id;
    c.distinct = S.num_nonoverlap; // counted before this block's tail increment
    c.last_mismatched_pos = cur_block_start;
    c.history_index = (int32_t)S.hist_start.size() - 1; // current block's ordinal
    // neighbor linking within the indel window (java:214-233)
    if (pos > 0) {
      int64_t prev_off = ks.offsets_sorted[pos - 1];
      int64_t d = prev_off - off;
      if ((d < 0 ? -d : d) <= S.max_indel) {
        int32_t pid = ks.ids_sorted[pos - 1];
        c.prev = pid;
        S.counters[pid].next = cid;
      }
    }
    if (pos < ks.offsets_sorted.size()) {
      int64_t next_off = ks.offsets_sorted[pos];
      int64_t d = next_off - off;
      if ((d < 0 ? -d : d) <= S.max_indel) {
        int32_t nid = ks.ids_sorted[pos];
        c.next = nid;
        S.counters[nid].prev = cid;
      }
    }
    S.counters.push_back(c);
    ks.offsets_sorted.insert(ks.offsets_sorted.begin() + pos, off);
    ks.ids_sorted.insert(ks.ids_sorted.begin() + pos, cid);
    ks.ids_insertion.push_back(cid);
  }

  int32_t prev = S.counters[cid].prev;
  int32_t next = S.counters[cid].next;
  if (prev >= 0) add_match(S, prev, cur_ord);
  if (next >= 0) add_match(S, next, cur_ord);
  bool update_this = true;
  if ((prev >= 0 && S.counters[prev].good) || (next >= 0 && S.counters[next].good)) {
    if (!S.counters[cid].good) update_this = false;
  }
  if (update_this) add_match(S, cid, cur_ord);
}

// try_ensure_good_match_counter (java:291-308)
void try_ensure_good(CountingState& S) {
  if (!S.found_good && (int64_t)S.counters.size() <= S.query_len) {
    for (KeyState& ks : S.keys)
      for (int32_t cid : ks.ids_insertion) declare_good(S, cid);
    S.found_good = true;
  }
}

// _get_next_interesting_block's defer rule: blocks overlapping an already
// visited non-overlapping span queue behind the main feed (FIFO).
int32_t next_block(CountingState& S) {
  while (S.feed_pos < S.nb) {
    int32_t w = (int32_t)S.feed_pos++;
    if ((int64_t)S.bstart[w] < S.max_nonoverlap) {
      S.pending.push_back(w);
      continue;
    }
    return w;
  }
  if (!S.pending.empty()) {
    int32_t w = S.pending.front();
    S.pending.pop_front();
    return w;
  }
  return -1;
}

int32_t counting_step(CountingState& S) {
  if (S.done) return 0;
  int32_t w;
  while (true) {
    w = next_block(S);
    if (w < 0) {
      S.done = true;
      if (S.num_blocks_anywhere < S.usual) try_ensure_good(S);
      return 0;
    }
    if (S.popular[w]) continue; // too-popular bin: match_block None
    break;
  }
  int32_t ord = (int32_t)S.hist_start.size();
  S.hist_start.push_back(S.bstart[w]);
  S.hist_end.push_back(S.bend[w]);
  for (int64_t r = S.bounds[w]; r < S.bounds[w + 1]; r++)
    update_matches(S, S.is_rc[r], S.fold_idx[r], S.fold_off[r], ord, S.bstart[w]);
  if ((int64_t)S.bstart[w] >= S.max_nonoverlap) {
    S.max_nonoverlap = S.bend[w];
    S.num_nonoverlap++;
  }
  S.num_blocks_anywhere++;
  S.min_distinct_memo = -1;
  return 1;
}

} // namespace

extern "C" {

void* mapper_counting_create(const int32_t* bstart, const int32_t* bend,
                             const uint8_t* popular, int64_t nb,
                             const int64_t* bounds, const int64_t* fold_idx,
                             const int64_t* fold_off, const uint8_t* is_rc,
                             const int64_t* seq_lengths, int64_t query_len,
                             int64_t max_indel, int64_t usual) {
  CountingState* S = new CountingState();
  S->bstart = bstart;
  S->bend = bend;
  S->popular = popular;
  S->bounds = bounds;
  S->fold_idx = fold_idx;
  S->fold_off = fold_off;
  S->is_rc = is_rc;
  S->seq_lengths = seq_lengths;
  S->nb = nb;
  S->query_len = query_len;
  S->max_indel = max_indel;
  S->usual = usual;
  return S;
}

void mapper_counting_destroy(void* h) { delete (CountingState*)h; }

int32_t mapper_counting_step(void* h) { return counting_step(*(CountingState*)h); }

// find_good_positions_having_priority_up_to's stepping loop
void mapper_counting_run_until_nonoverlap(void* h, int64_t target) {
  CountingState& S = *(CountingState*)h;
  while (S.num_nonoverlap < target) {
    if (!counting_step(S)) break;
  }
}

int64_t mapper_counting_num_blocks(void* h) {
  return ((CountingState*)h)->num_blocks_anywhere;
}
int64_t mapper_counting_num_nonoverlap(void* h) {
  return ((CountingState*)h)->num_nonoverlap;
}
int32_t mapper_counting_is_done(void* h) { return ((CountingState*)h)->done ? 1 : 0; }
int64_t mapper_counting_num_good(void* h) {
  return (int64_t)((CountingState*)h)->good_list.size();
}
int64_t mapper_counting_num_counters(void* h) {
  return (int64_t)((CountingState*)h)->counters.size();
}

// good counters with frozen priority <= priority_max, in declaration order
int64_t mapper_counting_good_upto(void* h, int64_t priority_max, int32_t* out_ids) {
  CountingState& S = *(CountingState*)h;
  int64_t n = 0;
  for (int32_t cid : S.good_list)
    if (S.counters[cid].priority <= priority_max) out_ids[n++] = cid;
  return n;
}

// get_best_matches: good counters at the minimum current distinct-mismatch
// count (seeded with num_nonoverlapping - 1)
int64_t mapper_counting_best(void* h, int32_t* out_ids) {
  CountingState& S = *(CountingState*)h;
  if (S.num_blocks_anywhere < S.usual) return 0;
  if (S.min_distinct_memo < 0) {
    int64_t minimum = S.num_nonoverlap - 1;
    for (int32_t cid : S.good_list) {
      counter_update(S, S.counters[cid]);
      int64_t count = S.counters[cid].distinct;
      if (minimum >= count) minimum = count;
    }
    S.min_distinct_memo = minimum;
  }
  int64_t n = 0;
  for (int32_t cid : S.good_list) {
    counter_update(S, S.counters[cid]);
    if (S.counters[cid].distinct <= S.min_distinct_memo) out_ids[n++] = cid;
  }
  return n;
}

// get_all_positions: key creation order x ascending offset
int64_t mapper_counting_all_positions(void* h, int32_t* out_ids) {
  CountingState& S = *(CountingState*)h;
  int64_t n = 0;
  for (KeyState& ks : S.keys)
    for (int32_t cid : ks.ids_sorted) out_ids[n++] = cid;
  return n;
}

// per-counter info: is_rc, contig, offset, frozen priority
void mapper_counting_info(void* h, const int32_t* ids, int64_t k, int64_t* out4) {
  CountingState& S = *(CountingState*)h;
  for (int64_t i = 0; i < k; i++) {
    const Counter& c = S.counters[ids[i]];
    const KeyState& ks = S.keys[c.key_id];
    out4[i * 4 + 0] = ks.is_rc;
    out4[i * 4 + 1] = ks.contig;
    out4[i * 4 + 2] = c.offset;
    out4[i * 4 + 3] = c.priority;
  }
}

// live priority attribute (0 until declared good, then frozen — mirrors
// MatchCounter.priority)
int64_t mapper_counting_priority(void* h, int32_t cid) {
  return ((CountingState*)h)->counters[cid].priority;
}

// get_num_distinct_mismatches (advances the counter's history scan)
int64_t mapper_counting_distinct(void* h, int32_t cid) {
  CountingState& S = *(CountingState*)h;
  counter_update(S, S.counters[cid]);
  return S.counters[cid].distinct;
}

} // extern "C"

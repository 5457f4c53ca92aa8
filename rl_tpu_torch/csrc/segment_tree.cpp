// Host-side sum and min segment trees for prioritized replay
// (counterpart of rl_tpu/csrc/segment_tree.cpp, same C interface).
//
// A dependency-free C ABI loaded with ctypes by rl_tpu_torch/csrc/__init__.py,
// with batched entry points so the Python call overhead amortizes over a
// whole sample batch. It backs HostPrioritizedSampler, the host tree that
// serves a device learner; the device path for PER is PrioritizedSampler
// with kernel B7.
//
// Layout: classic iterative segment tree over 2*size slots, size = next
// power of two >= capacity; leaves at [size, size+capacity).

#include <cstdint>
#include <cstring>
#include <limits>
#include <new>

namespace {

struct Tree {
  int64_t capacity;
  int64_t size;  // leaves offset (power of two)
  double* data;  // 2*size
  bool is_min;
};

inline double combine(const Tree* t, double a, double b) {
  return t->is_min ? (a < b ? a : b) : (a + b);
}

inline double identity(const Tree* t) {
  return t->is_min ? std::numeric_limits<double>::infinity() : 0.0;
}

Tree* tree_new(int64_t capacity, bool is_min) {
  if (capacity <= 0) return nullptr;
  int64_t size = 1;
  while (size < capacity) size <<= 1;
  Tree* t = new (std::nothrow) Tree;
  if (!t) return nullptr;
  t->capacity = capacity;
  t->size = size;
  t->is_min = is_min;
  t->data = new (std::nothrow) double[2 * size];
  if (!t->data) {
    delete t;
    return nullptr;
  }
  const double id0 = is_min ? std::numeric_limits<double>::infinity() : 0.0;
  for (int64_t i = 0; i < 2 * size; ++i) t->data[i] = id0;
  return t;
}

void point_set(Tree* t, int64_t idx, double value) {
  int64_t i = t->size + idx;
  t->data[i] = value;
  for (i >>= 1; i >= 1; i >>= 1)
    t->data[i] = combine(t, t->data[2 * i], t->data[2 * i + 1]);
}

double range_query(const Tree* t, int64_t l, int64_t r) {  // [l, r)
  double res_l = identity(t), res_r = identity(t);
  int64_t lo = t->size + l, hi = t->size + r;
  while (lo < hi) {
    if (lo & 1) res_l = combine(t, res_l, t->data[lo++]);
    if (hi & 1) res_r = combine(t, t->data[--hi], res_r);
    lo >>= 1;
    hi >>= 1;
  }
  return combine(t, res_l, res_r);
}

}  // namespace

extern "C" {

void* st_new(int64_t capacity, int32_t is_min) {
  return tree_new(capacity, is_min != 0);
}

void st_free(void* h) {
  Tree* t = static_cast<Tree*>(h);
  if (t) {
    delete[] t->data;
    delete t;
  }
}

int64_t st_capacity(void* h) { return static_cast<Tree*>(h)->capacity; }

void st_set(void* h, int64_t idx, double value) {
  point_set(static_cast<Tree*>(h), idx, value);
}

double st_get(void* h, int64_t idx) {
  Tree* t = static_cast<Tree*>(h);
  return t->data[t->size + idx];
}

void st_set_batch(void* h, const int64_t* idxs, const double* values, int64_t n) {
  Tree* t = static_cast<Tree*>(h);
  for (int64_t i = 0; i < n; ++i) point_set(t, idxs[i], values[i]);
}

void st_get_batch(void* h, const int64_t* idxs, double* out, int64_t n) {
  Tree* t = static_cast<Tree*>(h);
  for (int64_t i = 0; i < n; ++i) out[i] = t->data[t->size + idxs[i]];
}

// full-range reduction (sum tree: total mass; min tree: global min)
double st_reduce(void* h) {
  Tree* t = static_cast<Tree*>(h);
  return t->data[1];
}

double st_reduce_range(void* h, int64_t l, int64_t r) {
  return range_query(static_cast<Tree*>(h), l, r);
}

// prefix-sum search (sum trees): smallest idx such that
// sum(data[0..idx]) > u. The reference's `scan` op (segment_tree.h:243).
int64_t st_prefix_search(void* h, double u) {
  Tree* t = static_cast<Tree*>(h);
  int64_t i = 1;
  while (i < t->size) {
    i <<= 1;
    if (t->data[i] <= u) {
      u -= t->data[i];
      i += 1;
    }
  }
  int64_t idx = i - t->size;
  return idx < t->capacity ? idx : t->capacity - 1;
}

void st_prefix_search_batch(void* h, const double* us, int64_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) out[i] = st_prefix_search(h, us[i]);
}

}  // extern "C"

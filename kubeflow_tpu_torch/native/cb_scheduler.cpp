// Continuous-batching scheduler of the port: the request queue, the
// decode-slot lifecycle and the prefill-bucket choice (a copy of the JAX
// package's native/src/cb_scheduler.cpp, the same policy and C ABI).
//
// Pure scheduling logic, no tensor work: the Python engine owns the
// prefill waves, the decode chunks (CUDA graphs captured once per shape)
// and the KV cache; this library only ever hands out (slot, bucket) pairs
// from a fixed menu, so "which captured program runs next" is exactly the
// decision it makes.
//
// Multi-tenant fairness: requests carry a
// tenant id; the queue is per-tenant FIFO and the pop policy is max-min
// fair over decode slots — among tenants with queued work, prefer the one
// holding the FEWEST active slots (tie: oldest head request). A soft share
// cap (max_active_per_tenant) skips over-cap tenants while an under-cap
// tenant is waiting, but stays WORK-CONSERVING: when only over-cap tenants
// have queued work, free slots still serve them. Admission control is the
// hard per-tenant queue cap (max_queued_per_tenant): past it submits are
// rejected (-3) so one tenant's backlog cannot consume the shared queue.
// Single-tenant traffic (every request tenant 0) reduces exactly to the
// old global-FIFO policy.
//
// Exposed as a flat C ABI for ctypes (kubeflow_tpu_torch/native).
// Thread-safety: a single mutex guards every entry point — the engine loop
// and submitter threads may interleave freely.

#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <vector>

namespace {

struct Request {
  int64_t id;
  int32_t prompt_len;
  int32_t max_new_tokens;
  int32_t tenant;
  double submit_time;
};

struct Slot {
  bool active = false;
  int64_t req_id = -1;
  int32_t generated = 0;
  int32_t max_new_tokens = 0;
  int32_t tenant = 0;
};

struct Scheduler {
  std::mutex mu;
  // per-tenant FIFO; std::map keeps tenant iteration order deterministic
  // (the Python twin iterates sorted tenant ids for the same reason)
  std::map<int32_t, std::deque<Request>> queues;
  size_t total_queued = 0;
  std::vector<Slot> slots;
  std::vector<int32_t> buckets;  // sorted ascending prefill lengths
  size_t max_queue;
  int32_t max_active_per_tenant = 0;  // 0 = off (soft share cap)
  int32_t max_queued_per_tenant = 0;  // 0 = off (hard admission cap)
  int64_t next_id = 1;
  int64_t completed = 0;
  int64_t rejected = 0;
};

int find_free_slot(const Scheduler* s) {
  for (size_t i = 0; i < s->slots.size(); ++i)
    if (!s->slots[i].active) return static_cast<int>(i);
  return -1;
}

int32_t active_for_tenant(const Scheduler* s, int32_t tenant) {
  int32_t n = 0;
  for (const Slot& sl : s->slots)
    if (sl.active && sl.tenant == tenant) ++n;
  return n;
}

}  // namespace

extern "C" {

// Action codes returned by cbs_next.
enum { CBS_IDLE = 0, CBS_PREFILL = 1, CBS_DECODE = 2 };

void* cbs_create(int32_t max_slots, int32_t max_queue,
                 const int32_t* bucket_lens, int32_t n_buckets) {
  if (max_slots <= 0 || n_buckets <= 0) return nullptr;
  auto* s = new Scheduler();
  s->slots.resize(max_slots);
  s->max_queue = max_queue > 0 ? max_queue : 1024;
  s->buckets.assign(bucket_lens, bucket_lens + n_buckets);
  for (size_t i = 1; i < s->buckets.size(); ++i)
    if (s->buckets[i] < s->buckets[i - 1]) {  // enforce sorted menu
      delete s;
      return nullptr;
    }
  return s;
}

void cbs_destroy(void* h) { delete static_cast<Scheduler*>(h); }

// Per-tenant fairness knobs; 0 disables either. Takes effect on the next
// cbs_next / cbs_submit_t call (no queued state is re-evaluated here).
void cbs_set_fairness(void* h, int32_t max_active_per_tenant,
                      int32_t max_queued_per_tenant) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  s->max_active_per_tenant = max_active_per_tenant > 0
                                 ? max_active_per_tenant : 0;
  s->max_queued_per_tenant = max_queued_per_tenant > 0
                                 ? max_queued_per_tenant : 0;
}

// Enqueue for a tenant; returns request id, -1 if the global queue is
// full, -2 if the prompt exceeds the largest prefill bucket, -3 if the
// tenant is over its admission quota (max_queued_per_tenant).
int64_t cbs_submit_t(void* h, int32_t prompt_len, int32_t max_new_tokens,
                     double now, int32_t tenant) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  if (tenant < 0) tenant = 0;
  if (prompt_len <= 0 || prompt_len > s->buckets.back()) {
    s->rejected++;
    return -2;
  }
  if (s->total_queued >= s->max_queue) {
    s->rejected++;
    return -1;
  }
  std::deque<Request>& q = s->queues[tenant];
  if (s->max_queued_per_tenant > 0 &&
      q.size() >= static_cast<size_t>(s->max_queued_per_tenant)) {
    s->rejected++;
    return -3;
  }
  int64_t id = s->next_id++;
  q.push_back({id, prompt_len, max_new_tokens, tenant, now});
  s->total_queued++;
  return id;
}

// Back-compat single-tenant submit (tenant 0).
int64_t cbs_submit(void* h, int32_t prompt_len, int32_t max_new_tokens,
                   double now) {
  return cbs_submit_t(h, prompt_len, max_new_tokens, now, 0);
}

// Decide the next engine action. Prefill-priority policy: an empty decode
// slot plus a waiting request always prefills first (minimizes TTFT; decode
// throughput follows because the decode batch refills quickly). Tenant
// choice is max-min fair over slots (header comment).
// On CBS_PREFILL: out[0]=req_id, out[1]=slot, out[2]=bucket_len,
//                 out[3]=prompt_len, out[4]=max_new_tokens.
// On CBS_DECODE:  out[1]=number of active slots.
int32_t cbs_next(void* h, int64_t* out) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  int free_slot = find_free_slot(s);
  if (free_slot >= 0 && s->total_queued > 0) {
    // pick the tenant: fewest active slots, tie → oldest head request;
    // over-cap tenants only when no under-cap tenant has queued work
    int32_t best_tenant = -1, best_active = 0;
    int64_t best_head = 0;
    bool best_under = false;
    for (const auto& [tenant, q] : s->queues) {
      if (q.empty()) continue;
      int32_t a = active_for_tenant(s, tenant);
      bool under = s->max_active_per_tenant <= 0 ||
                   a < s->max_active_per_tenant;
      if (best_tenant < 0 || (under && !best_under) ||
          (under == best_under &&
           (a < best_active ||
            (a == best_active && q.front().id < best_head)))) {
        best_tenant = tenant;
        best_active = a;
        best_head = q.front().id;
        best_under = under;
      }
    }
    std::deque<Request>& q = s->queues[best_tenant];
    Request r = q.front();
    q.pop_front();
    // drop drained queues: pop cost and memory stay bounded by LIVE
    // tenants, not tenants ever seen (the Python twin mirrors this)
    if (q.empty()) s->queues.erase(best_tenant);
    s->total_queued--;
    Slot& sl = s->slots[free_slot];
    sl.active = true;
    sl.req_id = r.id;
    sl.generated = 0;
    sl.max_new_tokens = r.max_new_tokens;
    sl.tenant = r.tenant;
    int32_t bucket = s->buckets.back();
    for (int32_t b : s->buckets)
      if (b >= r.prompt_len) { bucket = b; break; }
    out[0] = r.id;
    out[1] = free_slot;
    out[2] = bucket;
    out[3] = r.prompt_len;
    out[4] = r.max_new_tokens;
    return CBS_PREFILL;
  }
  int64_t active = 0;
  for (const Slot& sl : s->slots) active += sl.active ? 1 : 0;
  if (active > 0) {
    out[1] = active;
    return CBS_DECODE;
  }
  return CBS_IDLE;
}

// Record one generated token for a slot. finished != 0 forces completion
// (EOS); hitting max_new_tokens completes implicitly. Returns 1 if the slot
// was freed, 0 if it stays active, -1 on bad slot.
int32_t cbs_token_done(void* h, int32_t slot, int32_t finished) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  if (slot < 0 || slot >= static_cast<int32_t>(s->slots.size())) return -1;
  Slot& sl = s->slots[slot];
  if (!sl.active) return -1;
  sl.generated++;
  if (finished || sl.generated >= sl.max_new_tokens) {
    sl.active = false;
    sl.req_id = -1;
    s->completed++;
    return 1;
  }
  return 0;
}

// Cancel a request wherever it lives. Returns 2 if an active slot was
// freed, 1 if the request was removed from the queue, 0 if unknown (never
// submitted, already finished, or already cancelled). Cancelled requests
// count neither as completed nor rejected — the engine layer keeps the
// cancellation metric (one place, same for both scheduler twins).
int32_t cbs_cancel(void* h, int64_t req_id) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  for (auto qit = s->queues.begin(); qit != s->queues.end(); ++qit) {
    std::deque<Request>& q = qit->second;
    for (auto it = q.begin(); it != q.end(); ++it) {
      if (it->id == req_id) {
        q.erase(it);
        if (q.empty()) s->queues.erase(qit);
        s->total_queued--;
        return 1;
      }
    }
  }
  for (Slot& sl : s->slots) {
    if (sl.active && sl.req_id == req_id) {
      sl.active = false;
      sl.req_id = -1;
      return 2;
    }
  }
  return 0;
}

// Which request occupies a slot (-1 if empty) — lets the engine map decode
// outputs back to requests without mirroring slot state in Python.
int64_t cbs_slot_request(void* h, int32_t slot) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  if (slot < 0 || slot >= static_cast<int32_t>(s->slots.size())) return -1;
  return s->slots[slot].active ? s->slots[slot].req_id : -1;
}

// Active slots currently held by a tenant (the fairness observable the
// loadgen runner / tests read; also usable for per-tenant metrics).
int32_t cbs_tenant_active(void* h, int32_t tenant) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  return active_for_tenant(s, tenant);
}

void cbs_stats(void* h, int64_t* queued, int64_t* active, int64_t* completed,
               int64_t* rejected) {
  auto* s = static_cast<Scheduler*>(h);
  std::lock_guard<std::mutex> lock(s->mu);
  *queued = static_cast<int64_t>(s->total_queued);
  int64_t a = 0;
  for (const Slot& sl : s->slots) a += sl.active ? 1 : 0;
  *active = a;
  *completed = s->completed;
  *rejected = s->rejected;
}

}  // extern "C"

// O(1) LFU block-residency manager for the host-offload KV tier.
//
// Native equivalent of the reference's single compiled component
// (vq_method/retrieval_based/lfu/src/lfu_cache.cc) with the same external
// contract: a caller-owned "proxy" array maps block-id -> cache slot, and a
// batched insert mutates it in place (admitted blocks get a slot, the
// evicted block's entry is reset to -1). The implementation here is the
// classic min-freq bucket LFU (hash map of nodes + per-frequency intrusive
// doubly-linked lists + a running minimum frequency), exposed through a
// plain C ABI for ctypes instead of pybind11. Ties evict the
// least-recently-used entry within the lowest frequency bucket.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC, run at first use by
// pqcache_tpu_torch/native/lfu_cache.py into pqcache_tpu_torch/build/lfu/.

#include <cstdint>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Node {
    int32_t key;
    int64_t freq;
    Node* prev = nullptr;
    Node* next = nullptr;
};

// Intrusive LRU list for one frequency value. Front = most recent.
struct Bucket {
    Node head;  // sentinel
    Bucket() { head.prev = head.next = &head; }
    bool empty() const { return head.next == &head; }
    void push_front(Node* n) {
        n->prev = &head;
        n->next = head.next;
        head.next->prev = n;
        head.next = n;
    }
    static void unlink(Node* n) {
        n->prev->next = n->next;
        n->next->prev = n->prev;
        n->prev = n->next = nullptr;
    }
    Node* back() { return head.prev; }
};

class Lfu {
  public:
    explicit Lfu(int64_t capacity) : capacity_(capacity) {}

    int64_t size() const { return nodes_.size(); }
    int64_t capacity() const { return capacity_; }

    // Returns 1 and bumps frequency if present, else 0.
    int touch(int32_t key) {
        auto it = nodes_.find(key);
        if (it == nodes_.end()) return 0;
        bump(&it->second);
        return 1;
    }

    int contains(int32_t key) const { return nodes_.count(key) ? 1 : 0; }

    // Insert-or-touch each block id; maintain the caller's slot proxy.
    void batched_insert(const int32_t* keys, int64_t n, int32_t* proxy,
                        int64_t proxy_len) {
        for (int64_t i = 0; i < n; ++i) {
            const int32_t key = keys[i];
            if (key < 0 || key >= proxy_len) continue;
            auto it = nodes_.find(key);
            if (it != nodes_.end()) {
                bump(&it->second);
                continue;
            }
            int32_t slot;
            if ((int64_t)nodes_.size() >= capacity_) {
                const int32_t victim = evict();
                slot = proxy[victim];
                proxy[victim] = -1;
            } else if (!free_slots_.empty()) {
                slot = free_slots_.back();
                free_slots_.pop_back();
            } else {
                slot = next_slot_++;
            }
            Node& node = nodes_[key];
            node.key = key;
            node.freq = 1;
            buckets_[1].push_front(&node);
            if (min_freq_ == 0 || min_freq_ > 1) min_freq_ = 1;
            proxy[key] = slot;
        }
    }

    // Drop block ids from the policy (residency invalidation — the
    // batched offload tier retires a serving slot and reuses its block-id
    // range for the next admitted sequence). Freed cache slots are
    // recycled by later insertions before any eviction happens.
    void batched_erase(const int32_t* keys, int64_t n, int32_t* proxy,
                       int64_t proxy_len) {
        for (int64_t i = 0; i < n; ++i) {
            const int32_t key = keys[i];
            if (key < 0 || key >= proxy_len) continue;
            auto it = nodes_.find(key);
            if (it == nodes_.end()) continue;
            Node* node = &it->second;
            const int64_t freq = node->freq;
            Bucket& b = buckets_.at(freq);
            Bucket::unlink(node);
            if (b.empty()) buckets_.erase(freq);
            nodes_.erase(it);
            if (proxy[key] >= 0) free_slots_.push_back(proxy[key]);
            proxy[key] = -1;
        }
        // recompute the running minimum (erase may have emptied its bucket)
        min_freq_ = 0;
        for (const auto& kv : buckets_)
            if (min_freq_ == 0 || kv.first < min_freq_)
                min_freq_ = kv.first;
    }

  private:
    void bump(Node* n) {
        Bucket& cur = buckets_[n->freq];
        Bucket::unlink(n);
        if (cur.empty()) {
            buckets_.erase(n->freq);
            if (min_freq_ == n->freq) min_freq_ = n->freq + 1;
        }
        n->freq += 1;
        buckets_[n->freq].push_front(n);
    }

    int32_t evict() {
        Bucket& b = buckets_.at(min_freq_);
        Node* victim = b.back();
        const int32_t key = victim->key;
        Bucket::unlink(victim);
        if (b.empty()) buckets_.erase(min_freq_);
        nodes_.erase(key);
        // min_freq_ is recomputed lazily: the next insert sets it to 1.
        if (!buckets_.count(min_freq_)) {
            min_freq_ = 0;
            for (const auto& kv : buckets_)
                if (min_freq_ == 0 || kv.first < min_freq_)
                    min_freq_ = kv.first;
        }
        return key;
    }

    int64_t capacity_;
    std::vector<int32_t> free_slots_;
    int32_t next_slot_ = 0;
    int64_t min_freq_ = 0;
    std::unordered_map<int32_t, Node> nodes_;
    std::unordered_map<int64_t, Bucket> buckets_;
};

struct Handle {
    Lfu lfu;
    std::thread worker;
    explicit Handle(int64_t cap) : lfu(cap) {}
    ~Handle() {
        if (worker.joinable()) worker.join();
    }
};

}  // namespace

extern "C" {

void* lfu_create(int64_t capacity) { return new Handle(capacity); }

void lfu_destroy(void* h) { delete static_cast<Handle*>(h); }

int64_t lfu_size(void* h) { return static_cast<Handle*>(h)->lfu.size(); }

int lfu_contains(void* h, int32_t key) {
    return static_cast<Handle*>(h)->lfu.contains(key);
}

int lfu_touch(void* h, int32_t key) {
    return static_cast<Handle*>(h)->lfu.touch(key);
}

void lfu_batched_insert(void* h, const int32_t* keys, int64_t n,
                        int32_t* proxy, int64_t proxy_len) {
    static_cast<Handle*>(h)->lfu.batched_insert(keys, n, proxy, proxy_len);
}

// Caller must synchronize first (no in-flight async insert): erase runs on
// the calling thread against the same proxy array.
void lfu_batched_erase(void* h, const int32_t* keys, int64_t n,
                       int32_t* proxy, int64_t proxy_len) {
    static_cast<Handle*>(h)->lfu.batched_erase(keys, n, proxy, proxy_len);
}

// Async variant: runs on a worker thread; caller must not touch `proxy`
// until lfu_synchronize returns (mirrors asyncBatchedInsertArray /
// synchronize of the reference API).
void lfu_batched_insert_async(void* h, const int32_t* keys, int64_t n,
                              int32_t* proxy, int64_t proxy_len) {
    Handle* handle = static_cast<Handle*>(h);
    if (handle->worker.joinable()) handle->worker.join();
    std::vector<int32_t> copy(keys, keys + n);
    handle->worker = std::thread(
        [handle, c = std::move(copy), proxy, proxy_len]() {
            handle->lfu.batched_insert(c.data(), (int64_t)c.size(), proxy,
                                       proxy_len);
        });
}

void lfu_synchronize(void* h) {
    Handle* handle = static_cast<Handle*>(h);
    if (handle->worker.joinable()) handle->worker.join();
}

}  // extern "C"
